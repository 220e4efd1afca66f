"""Port parity: the ray RHS and the termination physics.

The JAX background of ``jet_field`` is carried across with ``convert`` so
both packages sample the same numbers. States include NaN lon/ky/amp,
|lat| > pi/2, |ky| >= 100, the polar cap, lon < lon0 and lon > 2*pi.
Tolerance: NaN pattern and err flags identical row by row, values within
1e-13 of each row's max |value| (float64).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import rwrt_tpu as rt
from rwrt_tpu import tracer as jtracer
from rwrt_tpu.models import ray as jray
from rwrt_tpu_torch import convert
from rwrt_tpu_torch.models import ray as tray

TOL = 1e-13


def assert_rows_close(a, b, name, tol=TOL):
    a = np.atleast_2d(np.asarray(a))
    b = np.atleast_2d(b.numpy())
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=name)
    fin = np.isfinite(a)
    scale = np.max(np.abs(np.where(fin, a, 0.0)), axis=-1, keepdims=True)
    err = np.abs(np.where(fin, a - b, 0.0)) / np.maximum(scale, 1e-300)
    assert err.max() <= tol, (name, err.max())


@pytest.fixture(scope="module")
def backgrounds(jet_field):
    u, v, lat, lon = jet_field
    bgj = jtracer.make_background(
        rt.prepare(u, v, lat, lon, cal_dtype="float64"), 0.0)
    bgt = convert.background_from_numpy(
        {k: np.asarray(x) for k, x in bgj._asdict().items() if x is not None},
        device="cpu")
    return bgj, bgt


@pytest.fixture(scope="module")
def states():
    rng = np.random.default_rng(7)
    n = 3000
    y = np.stack([
        rng.uniform(-1.0, 7.3, n),
        rng.uniform(-1.65, 1.65, n),
        rng.uniform(0.5, 7.5, n),
        rng.normal(0.0, 40.0, n),
        rng.uniform(0.5, 2.0, n),
    ])
    y[1, :50] = np.pi / 2 - 1e-3       # polar cap
    y[1, 50:60] = np.pi / 2            # exactly on the pole
    for row, sl in ((0, np.s_[60:90]), (1, np.s_[90:100]), (2, np.s_[100:110]),
                    (3, np.s_[110:140]), (4, np.s_[140:170])):
        y[row, sl] = np.nan
    return y


@pytest.mark.parametrize("fn", ["rhs", "rhs_and_gv"])
def test_rhs_matches_jax(backgrounds, states, fn):
    bgj, bgt = backgrounds
    ref = getattr(jray, fn)(bgj, jnp.asarray(states))
    out = getattr(tray, fn)(bgt, torch.as_tensor(states))
    assert_rows_close(ref[0], out[0], "dy")
    if fn == "rhs":
        np.testing.assert_array_equal(np.asarray(ref[1]), out[1].numpy())
        # Sanity of the seeded cases: err lanes and NaN rows both occur.
        assert out[1].any() and torch.isnan(out[0]).any()
    else:
        assert_rows_close(ref[1], out[1], "ug")
        assert_rows_close(ref[2], out[2], "vg")


def test_rhs_nan_amp_poisons_row4_only(backgrounds):
    _, bgt = backgrounds
    y = torch.tensor([[1.0], [0.7], [3.0], [2.0], [float("nan")]],
                     dtype=torch.float64)
    dy, err = tray.rhs(bgt, y)
    assert torch.isfinite(dy[:4]).all() and torch.isnan(dy[4]).all()
    assert not err.any()


def test_ray_rhs_callable_is_rhs(backgrounds, states):
    _, bgt = backgrounds
    y = torch.as_tensor(states)
    assert torch.equal(torch.nan_to_num(tray.RayRHS(bgt)(y)),
                       torch.nan_to_num(tray.rhs(bgt, y)[0]))


@pytest.mark.parametrize("zero_invalid", [False, True])
def test_group_velocity_at_matches_jax(backgrounds, states, zero_invalid):
    bgj, bgt = backgrounds
    kx = states[2].copy()
    kx[200:220] = 0.0
    args = (states[0], states[1], kx, states[3])
    ref = jray.group_velocity_at(bgj, *(jnp.asarray(a) for a in args),
                                 zero_invalid=zero_invalid)
    out = tray.group_velocity_at(bgt, *(torch.as_tensor(a) for a in args),
                                 zero_invalid=zero_invalid)
    assert_rows_close(ref[0], out[0], "ug")
    assert_rows_close(ref[1], out[1], "vg")


def test_kill_and_fail_masks_match_jax(states):
    rng = np.random.default_rng(8)
    prev_lon = states[0] + rng.normal(0.0, 0.05, states.shape[1])
    prev_lat = states[1] + rng.normal(0.0, 0.05, states.shape[1])
    cut_off = 0.2
    ref_k = jray.kill_mask(jnp.asarray(states), jnp.asarray(prev_lon),
                           jnp.asarray(prev_lat), cut_off)
    out_k = tray.kill_mask(torch.as_tensor(states), torch.as_tensor(prev_lon),
                           torch.as_tensor(prev_lat), cut_off)
    np.testing.assert_array_equal(np.asarray(ref_k), out_k.numpy())
    assert 0 < out_k.sum() < out_k.numel()
    np.testing.assert_array_equal(
        np.asarray(jray.fail_mask(jnp.asarray(states))),
        tray.fail_mask(torch.as_tensor(states)).numpy())
    assert_rows_close(
        jray.haversine(*(jnp.asarray(a) for a in
                         (states[0], states[1], prev_lon, prev_lat))),
        tray.haversine(*(torch.as_tensor(a) for a in
                         (states[0], states[1], prev_lon, prev_lat))),
        "haversine")


def test_sample_bg_on_a_time_varying_stack_matches_jax(backgrounds,
                                                       states):
    """The static background as a one-frame (1, W, H, 48) time-varying
    stack: ``sample_bg`` takes the time branch, and equals the JAX
    package's at times before, on and after the frame, to the time
    samplers' bar (1e-12 of each row's max |value|: XLA fuses the time
    blend with contraction)."""
    bgj, bgt = backgrounds
    bg4j = bgj._replace(fields=bgj.fields[None])
    bg4t = bgt._replace(fields=bgt.fields[None])
    lon, lat = states[0], states[1]
    for t in (-5.0e5, 0.0, 3.3e4):
        ref = jray.sample_bg(bg4j, jnp.asarray(lon), jnp.asarray(lat), t)
        out = tray.sample_bg(bg4t, torch.as_tensor(lon), torch.as_tensor(lat),
                             t)
        assert_rows_close(ref, out, f"sample at t={t}", tol=1e-12)
