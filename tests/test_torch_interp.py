"""Port parity: background samplers and the Mercator transform.

Points include NaN positions, |lat| > pi/2, the polar cap, lon < lon0,
lon > 2*pi and a grid whose lon0 != 0. Tolerance: NaN masks identical,
values within 1e-13 of each field's max |value| (float64; the two packages
evaluate the same expressions, XLA may contract an FMA).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rwrt_tpu.ops import interp as jinterp
from rwrt_tpu_torch.ops import interp as tinterp

TOL = 1e-13


def assert_close(a, b, name):
    a = np.asarray(a)
    b = b.detach().cpu().numpy()
    assert a.shape == b.shape, name
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=name)
    fin = np.isfinite(a)
    if fin.any():
        scale = np.max(np.abs(np.where(fin, a, 0.0)), axis=-1, keepdims=True)
        err = np.abs(np.where(fin, a - b, 0.0)) / np.maximum(scale, 1e-300)
        assert err.max() <= TOL, (name, err.max())


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(3)
    nlon, nlat, c = 36, 19, 18
    fields = rng.normal(size=(nlon + 1, nlat, c))
    fields[-1] = fields[0]  # cyclic wrap column
    n = 400
    lon = rng.uniform(-1.0, 7.5, n)         # lon < lon0 and lon > 2*pi
    lat = rng.uniform(-1.7, 1.7, n)         # includes |lat| > pi/2
    lat[:20] = np.pi / 2 - rng.uniform(0, 0.015, 20)   # polar cap
    lat[20:40] = -np.pi / 2 + rng.uniform(0, 0.015, 20)
    lon[40:50] = np.nan
    lat[50:60] = np.nan
    return fields, lon, lat, 2 * np.pi / nlon, np.pi / (nlat - 1)


@pytest.mark.parametrize("lon0", [0.0, 0.3])
@pytest.mark.parametrize("sampler", ["sample_raw", "sample_mercator",
                                     "sample_raw_packed",
                                     "sample_mercator_packed"])
def test_sampler_matches_jax(case, sampler, lon0):
    fields, lon, lat, dx, dy = case
    lat0 = -np.pi / 2
    if "packed" in sampler:
        jf = jinterp.pack_corners(jnp.asarray(fields[..., :12]))
        tf = tinterp.pack_corners(torch.as_tensor(fields[..., :12]))
        np.testing.assert_array_equal(np.asarray(jf), tf.numpy())
    else:
        jf, tf = jnp.asarray(fields), torch.as_tensor(fields)
    ref = getattr(jinterp, sampler)(jf, lon0, lat0, dx, dy, jnp.asarray(lon),
                                    jnp.asarray(lat))
    out = getattr(tinterp, sampler)(tf, lon0, lat0, dx, dy,
                                    torch.as_tensor(lon), torch.as_tensor(lat))
    assert_close(ref, out, sampler)


def test_bilinear_gather_extrapolates_like_jax(case):
    fields = case[0]
    rng = np.random.default_rng(4)
    x = rng.uniform(-3.0, fields.shape[0] + 3.0, 300)
    y = rng.uniform(-3.0, fields.shape[1] + 3.0, 300)
    x[:5] = np.nan
    ref = jinterp.bilinear_gather(jnp.asarray(fields), jnp.asarray(x),
                                  jnp.asarray(y))
    out = tinterp.bilinear_gather(torch.as_tensor(fields), torch.as_tensor(x),
                                  torch.as_tensor(y))
    assert_close(ref, out, "bilinear_gather")


@pytest.mark.parametrize("channels", [12, 18])
def test_mercator_transform_matches_jax(case, channels):
    _, _, lat, _, _ = case
    rng = np.random.default_rng(5)
    raw = rng.normal(size=(lat.shape[0], channels))
    raw[60:70, 3] = np.nan
    ref = jinterp.mercator_transform(jnp.asarray(raw), jnp.asarray(lat))
    out = tinterp.mercator_transform(torch.as_tensor(raw),
                                     torch.as_tensor(lat))
    assert_close(ref, out, "mercator_transform")
    # The polar cap zeroes every field; NaN latitudes stay NaN (live).
    cap = np.abs(np.cos(lat)) <= 0.0175
    assert cap.any() and (out.numpy()[:, cap] == 0).all()
    assert np.isnan(out.numpy()[tinterp.M_U, np.isnan(lat)]).all()


def test_packed_sampler_equals_unpacked(case):
    """The single-gather packed path equals the 4-gather path bitwise."""
    fields, lon, lat, dx, dy = case
    hot = torch.as_tensor(fields[..., :12])
    a = tinterp.sample_raw(hot, 0.0, -np.pi / 2, dx, dy, torch.as_tensor(lon),
                           torch.as_tensor(lat))
    b = tinterp.sample_raw_packed(tinterp.pack_corners(hot), 0.0, -np.pi / 2,
                                  dx, dy, torch.as_tensor(lon),
                                  torch.as_tensor(lat))
    assert torch.equal(torch.isnan(a), torch.isnan(b))
    assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(b))


def bitwise(ref, out, name):
    """Equal to the bit, NaN where NaN (the two packages evaluate the same
    IEEE expressions, elementwise, with no reduction between them)."""
    a, b = np.asarray(ref), out.detach().cpu().numpy()
    assert a.shape == b.shape, name
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=name)
    np.testing.assert_array_equal(np.nan_to_num(a), np.nan_to_num(b),
                                  err_msg=name)


@pytest.fixture(scope="module")
def nonuniform():
    """Non-uniform ascending axes, a field with a finite sentinel and with
    NaN corners sprinkled in, and query points inside, outside in x and y,
    and on nodes."""
    rng = np.random.default_rng(7)
    nx, ny = 13, 9
    xi = np.cumsum(rng.uniform(0.5, 1.5, nx))
    yi = np.cumsum(rng.uniform(0.5, 1.5, ny))
    fi = rng.normal(size=(nx, ny))
    gaps = rng.random((nx, ny)) < 0.15
    xo = np.concatenate([rng.uniform(xi[0] - 3.0, xi[-1] + 3.0, 200),
                         xi[[0, 4, -1]]])
    yo = np.concatenate([rng.uniform(yi[0] - 2.0, yi[-1] + 2.0, 200),
                         yi[[1, 5, -1]]])
    return xi, yi, fi, gaps, xo, yo


@pytest.mark.parametrize("sentinel", [-999.0, np.nan], ids=["finite", "nan"])
@pytest.mark.parametrize("nopt", [1, -1])
@pytest.mark.parametrize("xcyclic", [True, False])
def test_linint2_point_matches_jax(nonuniform, xcyclic, nopt, sentinel):
    """Cyclic and non-cyclic, nopt +-1, out-of-range points, a finite
    sentinel (equality marks the missing corners) and the NaN sentinel
    (equality never fires; NaN propagates): bitwise equal to the JAX
    package (its own golden test needs the reference checkout)."""
    xi, yi, fi, gaps, xo, yo = nonuniform
    fi = np.where(gaps, sentinel, fi)
    kw = dict(xcyclic=xcyclic, fo_missing=sentinel, nopt=nopt)
    ref = jinterp.linint2_point(jnp.asarray(xi), jnp.asarray(yi),
                                jnp.asarray(fi), jnp.asarray(xo),
                                jnp.asarray(yo), **kw)
    out = tinterp.linint2_point(xi, yi, fi, xo, yo, **kw)
    bitwise(ref, out, f"linint2_point {kw}")
    assert np.isfinite(out.numpy()).any()
    if not np.isnan(sentinel):
        assert (out.numpy() == sentinel).any()


@pytest.mark.parametrize("fallback_mean", [False, True])
def test_bilinear_gather_masked_matches_jax(case, fallback_mean):
    """NaN corners: the result is NaN, or with fallback_mean the mean of
    the valid corners (NaN where none is); bitwise equal to JAX."""
    fields = case[0].copy()
    rng = np.random.default_rng(8)
    fields[rng.random(fields.shape[:2]) < 0.2] = np.nan
    fields[3:5, 3:5] = np.nan  # a cell with all four corners missing
    x = np.concatenate([rng.uniform(-2.0, fields.shape[0] + 2.0, 300),
                        [3.5]])
    y = np.concatenate([rng.uniform(-2.0, fields.shape[1] + 2.0, 300),
                        [3.5]])
    ref = jinterp.bilinear_gather_masked(
        jnp.asarray(fields), jnp.asarray(x), jnp.asarray(y),
        fallback_mean=fallback_mean)
    out = tinterp.bilinear_gather_masked(
        torch.as_tensor(fields), torch.as_tensor(x), torch.as_tensor(y),
        fallback_mean=fallback_mean)
    bitwise(ref, out, f"bilinear_gather_masked {fallback_mean}")
    assert np.isnan(out.numpy()[-1]).all()
    assert np.isfinite(out.numpy()).any()
