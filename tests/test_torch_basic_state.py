"""Port parity: grid operators, RunConfig and ``prepare`` against rwrt_tpu.

Same numpy inputs through the JAX package (CPU, float64) and the PyTorch
port (CPU, float64). Tolerance: every field within 1e-11 of its max |value|,
undef (NaN) cells equal. Both sides evaluate the same expressions in the same
order; what remains is XLA's FMA contraction, at the 1e-15 level.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import rwrt_tpu as rt
import rwrt_tpu_torch as pt
from rwrt_tpu.ops import grid as jgrid
from rwrt_tpu_torch.ops import grid as tgrid

TOL = 1e-11


def climatology_background(nlon=144, nlat=73):
    """The repository benchmark's 144 x 73 background (bench.py)."""
    lat = np.linspace(-np.pi / 2, np.pi / 2, nlat)
    lon = np.arange(nlon) * 2 * np.pi / nlon
    u = (
        25.0 * np.cos(lat)[None, :] ** 2
        + 30.0 * np.exp(-(((np.degrees(lat)[None, :] - 35.0) / 12.0) ** 2))
        + 6.0 * np.cos(3 * lon)[:, None] * np.cos(lat)[None, :] ** 2
    )
    v = 4.0 * np.sin(2 * lon)[:, None] * np.cos(lat)[None, :]
    return u, v, lat, lon


def assert_field_close(a, b, name):
    a = np.asarray(a)
    b = b.detach().cpu().numpy() if torch.is_tensor(b) else np.asarray(b)
    assert a.shape == b.shape, (name, a.shape, b.shape)
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=name)
    scale = max(np.nanmax(np.abs(a)), 1e-300)
    err = np.nanmax(np.abs(a - b)) / scale if np.isfinite(a).any() else 0.0
    assert err <= TOL, (name, err)


@pytest.fixture(scope="module")
def field():
    rng = np.random.default_rng(0)
    nlon, nlat = 24, 13
    lat = np.linspace(-np.pi / 2, np.pi / 2, nlat)
    f = rng.normal(size=(nlon, nlat))
    g = rng.normal(size=(nlon, nlat)) + 10.0
    return f, g, lat, 2 * np.pi / nlon, np.pi / (nlat - 1)


GRID_OPS = {
    "gradient_x": lambda m, f, g, lat, dx, dy: m.gradient_x(f, dx),
    "gradient_y": lambda m, f, g, lat, dx, dy: m.gradient_y(f, dy),
    "gradient_xx": lambda m, f, g, lat, dx, dy: m.gradient_xx(f, dx),
    "gradient_yy": lambda m, f, g, lat, dx, dy: m.gradient_yy(f, dy),
    "gradient_xy": lambda m, f, g, lat, dx, dy: m.gradient_xy(f, dx, dy),
    "smth9": lambda m, f, g, lat, dx, dy: m.smth9(f),
    "absolute_vorticity": lambda m, f, g, lat, dx, dy:
        m.absolute_vorticity(g, f, lat, dx, dy),
    "betam_field": lambda m, f, g, lat, dx, dy: m.betam_field(g, f, f, lat),
    "stationary_wavenumber": lambda m, f, g, lat, dx, dy:
        m.stationary_wavenumber(f, g - 10.0, lat),
}


@pytest.mark.parametrize("op", sorted(GRID_OPS))
def test_grid_op_matches_jax(field, op):
    f, g, lat, dx, dy = field
    fn = GRID_OPS[op]
    ref = fn(jgrid, jnp.asarray(f), jnp.asarray(g), jnp.asarray(lat),
             jnp.asarray(dx), jnp.asarray(dy))
    out = fn(tgrid, torch.as_tensor(f), torch.as_tensor(g),
             torch.as_tensor(lat), torch.tensor(dx, dtype=torch.float64),
             torch.tensor(dy, dtype=torch.float64))
    assert_field_close(ref, out, op)


def test_smth9_leaves_its_border_window_unsmoothed(field):
    f = torch.as_tensor(field[0])
    out = tgrid.smth9(f)
    # The [1:-2, 1:-2] window quirk: rows/columns 0, -2 and -1 untouched.
    for sl in (np.s_[0, :], np.s_[-1, :], np.s_[-2, :], np.s_[:, 0],
               np.s_[:, -1], np.s_[:, -2]):
        assert torch.equal(out[sl], f[sl])
    assert not torch.equal(out[1:-2, 1:-2], f[1:-2, 1:-2])


@pytest.mark.parametrize("background", ["jet", "climatology"])
def test_prepare_matches_jax(jet_field, background):
    u, v, lat, lon = (jet_field if background == "jet"
                      else climatology_background())
    ref = rt.prepare(u, v, lat, lon, cal_dtype="float64")
    out = pt.prepare(u, v, lat, lon, cal_dtype="float64", device="cpu")
    for name in ("fields", "lon", "lat", "betam", "ks", "q"):
        assert_field_close(getattr(ref, name), getattr(out, name), name)
    assert out.xcyclic is True and out.fields.dtype == torch.float64


def test_prepare_rolls_lon_like_jax(jet_field):
    """A -180..180 grid is rolled to start at its smallest lon mod 2*pi."""
    u, v, lat, lon = jet_field
    k = u.shape[0] // 2
    lon_shift = np.roll(lon, k)
    lon_shift = np.where(lon_shift >= np.pi, lon_shift - 2 * np.pi, lon_shift)
    args = (np.roll(u, k, axis=0), np.roll(v, k, axis=0), lat, lon_shift)
    ref = rt.prepare(*args, cal_dtype="float64")
    out = pt.prepare(*args, cal_dtype="float64", device="cpu")
    assert_field_close(ref.fields, out.fields, "fields")
    assert_field_close(ref.lon, out.lon, "lon")


def test_prepare_float32_ingest_matches_jax(jet_field):
    """The default read/compute dtype is float32, cast as the JAX package
    casts (1e-5 of each field's max: float32 round-off)."""
    u, v, lat, lon = jet_field
    ref = np.asarray(rt.prepare(u, v, lat, lon).fields)
    out = pt.prepare(u, v, lat, lon, device="cpu").fields.numpy()
    assert out.dtype == np.float32
    assert np.abs(ref - out).max() / np.abs(ref).max() < 1e-5


@pytest.mark.parametrize("bad", ["gaussian_lat", "descending_lat",
                                 "regional_lon"])
def test_prepare_refuses_non_uniform_axes(jet_field, bad):
    u, v, lat, lon = jet_field
    if bad == "gaussian_lat":
        lat = np.sin(np.linspace(-1.4, 1.4, lat.shape[0]))
    elif bad == "descending_lat":
        lat = lat[::-1]
    else:
        lon = lon * 0.5
    with pytest.raises(ValueError):
        rt.prepare(u, v, lat, lon)
    with pytest.raises(ValueError):
        pt.prepare(u, v, lat, lon, device="cpu")


def test_run_config_defaults_match_jax():
    ref = {f.name: f.default for f in dataclasses.fields(rt.RunConfig)}
    out = {f.name: f.default for f in dataclasses.fields(pt.RunConfig)}
    assert ref == out
    cfg_r, cfg_p = rt.RunConfig(), pt.RunConfig()
    for prop in ("nt", "nsource", "nzwn", "cut_off_rad"):
        assert getattr(cfg_r, prop) == getattr(cfg_p, prop)


@pytest.mark.parametrize("bad", [
    dict(integrator="euler"), dict(root_order="x"), dict(nnx=0),
    dict(sw_lat=85.0, dlat=10.0), dict(tstep=0.0), dict(zwn=()),
    dict(rtol=0.0), dict(interval_batch=0), dict(bound_mode="dense"),
    dict(integrator="rk45", bound_mode="dense", interval_batch=1),
    dict(pin_limit=5), dict(integrator="rk45", bound_mode="dense",
                            pin_limit=5, pin_mwn=150.0),
    dict(peel_caps=(4, 2)), dict(shsf_mode="x"), dict(state_dtype="x"),
])
def test_run_config_validate_rejects_like_jax(bad):
    with pytest.raises(ValueError):
        rt.RunConfig(**bad).validate()
    with pytest.raises(ValueError):
        pt.RunConfig(**bad).validate()
