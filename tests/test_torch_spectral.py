"""Port parity: the spectral sampler and its fit.

The port's plain ``sample_spectral`` against the JAX package's
``sample_spectral`` and its Pallas kernel ``sample_spectral_pallas`` run in
interpret mode on the CPU, at tests/test_spectral_sample.py's bars: 1e-12
in float64, 1e-5 in float32, NaN rows for |lat| > pi/2 and NaN positions,
and bf16 matmul operands.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import rwrt_tpu as rt
from rwrt_tpu.ops import spectral_sample as jspec
from rwrt_tpu_torch import convert
from rwrt_tpu_torch.ops import spectral_sample as tspec


def grid(nlon, nlat):
    return (np.arange(nlon) * 2 * np.pi / nlon,
            np.linspace(-np.pi / 2, np.pi / 2, nlat))


def fits(dtype, m_max=None, l_max=None, seed=6):
    nlon, nlat = 36, 19
    lon, lat = grid(nlon, nlat)
    fields = np.random.default_rng(seed).normal(size=(nlon, nlat, 12))
    fields = fields.astype(dtype)
    kw = dict(lon=lon, lat=lat, m_max=m_max, l_max=l_max)
    return jspec.fit_spectral(fields, **kw), tspec.fit_spectral(fields, **kw)


def points(dtype, n=700, seed=7):
    rng = np.random.default_rng(seed)
    lon = rng.uniform(-1.0, 7.0, n)
    lat = rng.uniform(-1.6, 1.6, n)      # some |lat| > pi/2
    lon[:7] = np.nan
    return lon.astype(dtype), lat.astype(dtype)


@pytest.mark.parametrize("trunc", [(None, None), (9, 11)])
def test_fit_matches_jax(trunc):
    ref, out = fits(np.float64, *trunc)
    np.testing.assert_allclose(out.coeffs.numpy(), np.asarray(ref.coeffs),
                               rtol=0, atol=1e-12)
    assert float(out.lat0) == float(ref.lat0)
    assert (out.m_max, out.l_max, out.num_fields) == (ref.m_max, ref.l_max,
                                                      ref.num_fields)


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12),
                                       (np.float32, 1e-5)])
@pytest.mark.parametrize("against", ["sample_spectral",
                                     "sample_spectral_pallas"])
def test_sample_matches_jax(dtype, tol, against):
    ref_fit, out_fit = fits(dtype)
    lon, lat = points(dtype)
    kw = dict(interpret=True) if against.endswith("pallas") else {}
    ref = np.asarray(getattr(jspec, against)(
        ref_fit, jnp.asarray(lon), jnp.asarray(lat), **kw))
    out = tspec.sample_spectral(out_fit, torch.as_tensor(lon),
                                torch.as_tensor(lat)).numpy()
    np.testing.assert_array_equal(np.isnan(ref), np.isnan(out))
    assert np.isnan(out[np.abs(lat) > np.pi / 2]).all()
    assert np.isnan(out[:7]).all()
    np.testing.assert_allclose(out, ref, rtol=tol, atol=tol)


@pytest.mark.parametrize("against", ["sample_spectral",
                                     "sample_spectral_pallas"])
def test_bf16_operands_match_jax(against):
    ref_fit, out_fit = fits(np.float32)
    lon, lat = points(np.float32)
    kw = dict(interpret=True) if against.endswith("pallas") else {}
    ref = np.asarray(getattr(jspec, against)(
        ref_fit, jnp.asarray(lon), jnp.asarray(lat),
        matmul_dtype=jnp.bfloat16, **kw))
    out = tspec.sample_spectral(out_fit, torch.as_tensor(lon),
                                torch.as_tensor(lat),
                                matmul_dtype=torch.bfloat16).numpy()
    np.testing.assert_array_equal(np.isnan(ref), np.isnan(out))
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    # bf16 operands stay within bf16 error of the float32 result.
    f32 = tspec.sample_spectral(out_fit, torch.as_tensor(lon),
                                torch.as_tensor(lat)).numpy()
    scale = np.nanmax(np.abs(f32))
    assert np.nanmax(np.abs(out - f32)) / scale < 0.03


def test_fit_of_basic_state_is_exact_at_grid_points(jet_field):
    """Full truncation reproduces the stack on its own grid; the fit of a
    converted JAX state equals the JAX fit."""
    u, v, lat, lon = jet_field
    bsj = rt.prepare(u, v, lat, lon, cal_dtype="float64")
    bst = convert.basic_state_from_numpy(
        {k: np.asarray(x) for k, x in bsj._asdict().items()})
    ref, out = jspec.fit_spectral(bsj), tspec.fit_spectral(bst)
    np.testing.assert_allclose(out.coeffs.numpy(), np.asarray(ref.coeffs),
                               rtol=0, atol=1e-9)
    glon, glat = np.meshgrid(lon, lat[1:-1], indexing="ij")
    vals = tspec.sample_spectral(out, torch.as_tensor(glon.ravel()),
                                 torch.as_tensor(glat.ravel())).numpy()
    stack = bst.fields.numpy()[:-1, 1:-1].reshape(-1, 18)
    scale = np.abs(stack).max(axis=0)
    assert (np.abs(vals - stack) / scale).max() < 1e-10


def test_cuda_wrapper_on_cpu_is_the_plain_version():
    _, out_fit = fits(np.float64)
    lon, lat = points(np.float64)
    before = tspec.LAUNCHES
    a = tspec.sample_spectral_cuda(out_fit, torch.as_tensor(lon),
                                   torch.as_tensor(lat))
    b = tspec.sample_spectral(out_fit, torch.as_tensor(lon),
                              torch.as_tensor(lat))
    assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(b))
    assert tspec.LAUNCHES == before


def test_mercator_spectral_matches_jax():
    ref_fit, out_fit = fits(np.float64)
    lon, lat = points(np.float64)
    ref = np.asarray(jspec.sample_mercator_spectral(
        ref_fit, jnp.asarray(lon), jnp.asarray(lat)))
    out = tspec.sample_mercator_spectral(out_fit, torch.as_tensor(lon),
                                         torch.as_tensor(lat)).numpy()
    np.testing.assert_array_equal(np.isnan(ref), np.isnan(out))
    np.testing.assert_allclose(out, ref, rtol=1e-12, atol=1e-12)
