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
