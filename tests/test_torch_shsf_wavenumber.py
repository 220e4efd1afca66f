"""SHSF and the grid-wide wavenumber maps of the port against the JAX
package's, on the ``jet_field`` background in float64: within 1e-10 of
each output's largest magnitude, NaN masks identical. The float32 SHSF (the
CLI's default read_dtype) is held to 1e-5 of the field's largest magnitude,
float32 round-off amplified by the two FFTs and the products.
"""

import numpy as np
import pytest
import torch

import rwrt_tpu as rt
from rwrt_tpu.diagnostics import spectral as jspec
from rwrt_tpu.diagnostics import wavenumber as jwn
from rwrt_tpu_torch import convert
from rwrt_tpu_torch.diagnostics import spectral as pspec
from rwrt_tpu_torch.diagnostics import wavenumber as pwn

ZWN = np.array([0.0, 1.0, 3.0, 5.0])


def assert_close(ref, got, rtol=1e-10):
    ref, got = np.asarray(ref), np.asarray(got)
    assert ref.shape == got.shape
    np.testing.assert_array_equal(np.isnan(ref), np.isnan(got))
    scale = np.nanmax(np.abs(ref))
    np.testing.assert_allclose(got, ref, rtol=0, atol=rtol * scale)


def rough(jet_field):
    u, _, lat, _ = jet_field
    return u + 0.5 * np.random.default_rng(7).standard_normal(u.shape), lat


@pytest.mark.parametrize("frames", [1, 3], ids=["2d", "3d"])
def test_shsf_projection_matches_jax(jet_field, frames):
    u, lat = rough(jet_field)
    data = u if frames == 1 else np.stack([u * (1 + 0.1 * i)
                                           for i in range(frames)])
    ref = np.asarray(jspec.shsf(data, lat, 8))
    got = pspec.shsf(torch.as_tensor(data), lat, 8)
    assert got.dtype == torch.float64
    assert_close(ref, got.numpy())
    assert not np.allclose(got.numpy(), data)


def test_shsf_dh_matches_jax():
    n, nlon = 32, 64
    lat = np.pi / 2 - np.pi * np.arange(n)[::-1] / n
    lon = np.arange(nlon) * 2 * np.pi / nlon
    rng = np.random.default_rng(1)
    f = (np.cos(lat)[None, :] ** 2 * np.cos(3 * lon)[:, None]
         + 0.3 * rng.standard_normal((nlon, n)))
    ref = np.asarray(jspec.shsf(f, lat, 10, mode="dh"))
    assert_close(ref, pspec.shsf(f, lat, 10, mode="dh", device="cpu").numpy())
    with pytest.raises(ValueError, match="Driscoll"):
        pspec.shsf(f, np.linspace(-np.pi / 2, np.pi / 2, n), 10, mode="dh",
                   device="cpu")
    with pytest.raises(ValueError, match="unknown mode"):
        pspec.shsf(f, lat, 10, mode="nope", device="cpu")


def test_shsf_float32_matches_jax(jet_field):
    """The ingest path's default: the input read in float32 and filtered in
    float32."""
    u, lat = rough(jet_field)
    u32 = u.astype(np.float32)
    ref = np.asarray(jspec.shsf(u32, lat, 8))
    got = pspec.shsf(u32, lat, 8, device="cpu")
    assert got.dtype == torch.float32
    assert_close(ref, got.numpy(), rtol=1e-5)


def test_shsf_array_input_runs_on_device(jet_field):
    """An array is filtered on ``device``, the card unless the caller asks
    otherwise; a tensor stays on its own device whatever ``device`` says."""
    u, lat = rough(jet_field)
    assert pspec.shsf(u, lat, 8, device="meta").device.type == "meta"
    assert pspec.shsf(torch.as_tensor(u), lat, 8,
                      device="meta").device.type == "cpu"
    if not torch.cuda.is_available():
        # No silent fall-back to the host for the default.
        with pytest.raises((AssertionError, RuntimeError)):
            pspec.shsf(u, lat, 8)


@pytest.fixture(scope="module")
def states(jet_field):
    u, v, lat, lon = jet_field
    out = {}
    bsj = rt.prepare(u, v, lat, lon, cal_dtype="float64")
    out["static"] = (bsj, convert.basic_state_from_numpy(
        {k: np.asarray(x) for k, x in bsj._asdict().items()}, device="cpu"))
    us, vs = np.stack([u, 1.2 * u]), np.stack([v, 0.8 * v])
    tvj = rt.prepare_time_varying(us, vs, lat, lon, bg_dt=86400.0,
                                  cal_dtype="float64")
    out["varying"] = (tvj, convert.basic_state_from_numpy(
        {k: np.asarray(x) for k, x in tvj._asdict().items()}, device="cpu"))
    return out


@pytest.mark.parametrize("kind", ["static", "varying"])
def test_compute_wavenumber_maps_matches_jax(states, kind):
    bsj, bsp = states[kind]
    ref = jwn.compute_wavenumber_maps(bsj, ZWN, freq=0.0)
    got = pwn.compute_wavenumber_maps(bsp, ZWN, freq=0.0)
    lead = (2,) if kind == "varying" else ()
    assert tuple(got.mwn.shape) == lead + (72, 37, 4, 3)
    for name in ("mwn", "ug", "vg"):
        assert_close(getattr(ref, name), getattr(got, name).numpy())
    np.testing.assert_array_equal(np.asarray(ref.rootnum),
                                  got.rootnum.numpy())
    assert set(np.unique(got.rootnum.numpy())) >= {0, 1, 3}


def test_postprocess_maps_matches_jax(states):
    bsj, bsp = states["static"]
    ref = jwn.postprocess_maps(jwn.compute_wavenumber_maps(bsj, ZWN))
    got = pwn.postprocess_maps(pwn.compute_wavenumber_maps(bsp, ZWN))
    for name in ("mwn", "ug", "vg"):
        assert_close(getattr(ref, name), getattr(got, name).numpy())
    np.testing.assert_array_equal(np.asarray(ref.rootnum),
                                  got.rootnum.numpy())


def test_turning_critical_masks_matches_jax(states):
    bsj, bsp = states["static"]
    ref = np.asarray(jwn.turning_critical_masks(bsj, ZWN))
    got = pwn.turning_critical_masks(bsp, ZWN).numpy()
    np.testing.assert_array_equal(ref, got)
    assert got.any() and not got.all()


def test_wavenumber_maps_refuse_a_mesh(states):
    """A ``mesh`` that is not a ``parallel.sharding.Mesh`` raises TypeError
    (the maps under a mesh: tests/test_torch_parallel.py)."""
    _, bsp = states["static"]
    with pytest.raises(TypeError, match="Mesh"):
        pwn.compute_wavenumber_maps(bsp, ZWN, mesh=object())
