"""Port parity: the dense adaptive Dormand-Prince integrator.

Two right-hand sides drive both packages' ``integrate_group_dense``:

- the ray RHS on the ``jet_field`` background (carried across with
  ``convert``), over 2 groups of 16 bounds, pin off and pin (500, 0);
- the synthetic lanes of tests/test_pin_kill.py (easy, grinding, and a
  perpetual-rejection grinder), whose pin-kill outcome is exact.

Tolerances. Step-level parity is tight: after the first trips the states
agree to 1e-12. Over whole groups the adaptive controller amplifies
round-off: XLA contracts FMAs where PyTorch rounds each op, and a one-ulp
difference in a lane's state changes its accepted step sizes within a few
trips. ``test_jax_moves_itself_under_one_ulp`` measures that on the same
case: the JAX package against itself, with lon moved by one ulp, differs by
more than 1e-6 of scale on some lanes within one group of 16 bounds. So the
group comparison requires identical NaN patterns, 85 % of the lanes within
1e-9 of scale, and every lane within twice the JAX package's own one-ulp
spread on the same carry, read in the same test. The synthetic lanes, which
carry no chaotic amplification, are held to 1e-9 on every value.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import rwrt_tpu as rt
from rwrt_tpu import tracer as jtracer
from rwrt_tpu.models import ray as jray
from rwrt_tpu.solvers import rk45 as jrk
from rwrt_tpu_torch import convert
from rwrt_tpu_torch import tracer as ttracer
from rwrt_tpu_torch.models import ray as tray
from rwrt_tpu_torch.solvers import rk45 as trk

DT = 7200.0


@pytest.fixture(scope="module")
def ray_case(jet_field):
    u, v, lat, lon = jet_field
    bgj = jtracer.make_background(
        rt.prepare(u, v, lat, lon, cal_dtype="float64"), 0.0)
    bgt = convert.background_from_numpy(
        {k: np.asarray(x) for k, x in bgj._asdict().items() if x is not None},
        device="cpu")
    slon, slat = jtracer.source_matrix(0.0, 5.0, 36.0, 8.0, 5, 4)
    y0, _, _ = jtracer.initialize(bgj, jnp.asarray(slon), jnp.asarray(slat),
                                  jnp.asarray([2.0, 4.0, 6.0]))
    y0 = np.array(y0)  # writable copies: torch.as_tensor shares the memory
    h0 = np.array(jtracer.initial_step_sizes(bgj, jnp.asarray(y0), 1e-6,
                                             1e-6))
    return bgj, bgt, y0, h0


def run_both(ray_case, bounds, max_iters=1_000_000, pin=None, carry=None):
    """One dense group through both packages from the same numpy carry."""
    bgj, bgt, y0, h0 = ray_case
    r = y0.shape[1]
    y, t, h = carry if carry is not None else (y0, np.zeros(r), h0)
    jrhs = lambda yy, tt=0.0: jray.rhs(bgj, yy, tt)[0]  # noqa: E731
    jpin = {} if pin is None else dict(
        pin_limit=jnp.asarray(pin[0], jnp.int32), pin_mwn=jnp.asarray(pin[1]))
    ref = jrk.integrate_group_dense(
        jrhs, jnp.asarray(y), jnp.asarray(t), jnp.asarray(h),
        jrhs(jnp.asarray(y)), jnp.asarray(bounds), 1e-6, 1e-6, 7.2,
        max_iters=max_iters, **jpin)
    trhs = tray.RayRHS(bgt)
    tpin = {} if pin is None else dict(pin_limit=pin[0], pin_mwn=pin[1])
    yt = torch.as_tensor(y)
    out = trk.integrate_group_dense(
        trhs, yt, torch.as_tensor(t), torch.as_tensor(h), trhs(yt),
        torch.as_tensor(bounds), 1e-6, 1e-6, 7.2, max_iters=max_iters,
        **tpin)
    return ref, out


def per_lane_diff(a, b):
    """max over bounds and rows of |a - b| / (row's max |a|), per lane."""
    scale = np.nanmax(np.abs(a), axis=(0, 2))[None, :, None]
    return (np.nan_to_num(np.abs(a - b)) / scale).max(axis=(0, 1))


def jax_one_ulp_spread(ray_case, bounds, carry, pin):
    """The JAX package against itself on one group, lon moved by one ulp:
    per-lane differences (the bar the round-off allows)."""
    bgj, _, y0, h0 = ray_case
    y, t, h = carry if carry is not None else (y0, np.zeros(y0.shape[1]), h0)
    yp = y.copy()
    yp[0] = np.nextafter(yp[0], np.inf)
    jrhs = lambda yy, tt=0.0: jray.rhs(bgj, yy, tt)[0]  # noqa: E731
    jpin = {} if pin is None else dict(
        pin_limit=jnp.asarray(pin[0], jnp.int32), pin_mwn=jnp.asarray(pin[1]))
    a, b = (np.asarray(jrk.integrate_group_dense(
        jrhs, jnp.asarray(yy), jnp.asarray(t), jnp.asarray(h),
        jrhs(jnp.asarray(yy)), jnp.asarray(bounds), 1e-6, 1e-6, 7.2,
        **jpin)[0]) for yy in (y, yp))
    return per_lane_diff(a, b)


def np_out(out):
    return [o.numpy() if torch.is_tensor(o) else np.asarray(o) for o in out]


def test_select_initial_step_matches_jax(ray_case):
    bgj, bgt, y0, h0 = ray_case
    h = ttracer.initial_step_sizes(bgt, torch.as_tensor(y0), 1e-6, 1e-6)
    np.testing.assert_array_equal(np.isnan(h0), np.isnan(h.numpy()))
    np.testing.assert_allclose(h.numpy(), h0, rtol=1e-12)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_validate_tol_clamps_like_jax(dtype):
    ref = float(jrk.validate_tol(1e-6, np.dtype(str(dtype)[6:])))
    assert trk.validate_tol(1e-6, dtype) == pytest.approx(ref, rel=1e-7)


def test_dense_entry_state_matches_jax(ray_case):
    _, _, y0, _ = ray_case
    bounds = np.arange(1, 17) * DT
    ref = jrk.dense_entry_state(jnp.asarray(y0), jnp.asarray(bounds))
    out = trk.dense_entry_state(torch.as_tensor(y0), torch.as_tensor(bounds))
    for a, b in zip(ref, np_out(out)):
        np.testing.assert_array_equal(np.asarray(a), b)


@pytest.mark.parametrize("trips", [1, 2, 3])
def test_first_trips_match_jax(ray_case, trips):
    ref, out = run_both(ray_case, np.arange(1, 17) * DT, max_iters=trips)
    for i, name in ((0, "hist"), (1, "y"), (2, "t"), (3, "h"), (4, "f")):
        a, b = np.asarray(ref[i]), out[i].numpy()
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b), name)
        np.testing.assert_allclose(b, a, rtol=1e-12, atol=1e-12 * np.nanmax(
            np.abs(a)), err_msg=name)
    np.testing.assert_array_equal(np.asarray(ref[7]), out[7].numpy())


def test_jax_moves_itself_under_one_ulp(ray_case):
    """The reading behind the group bars: one ulp of lon moves the JAX
    package's own trajectories past 1e-9 of scale on some lanes in one group
    of 16 bounds (by up to ~4e-5 on this case), and never past 1e-4."""
    d = jax_one_ulp_spread(ray_case, np.arange(1, 17) * DT, None, None)
    assert d.max() > 1e-6, d.max()
    assert d.max() <= 1e-4, d.max()
    assert (d > 1e-9).sum() >= 5, np.sort(d)[-8:]


@pytest.mark.parametrize("pin", [None, (500, 0.0)])
def test_two_groups_match_jax(ray_case, pin):
    carry = None
    for g in range(2):
        bounds = np.arange(16 * g + 1, 16 * g + 17) * DT
        ref, out = run_both(ray_case, bounds, pin=pin, carry=carry)
        a, b = np.asarray(ref[0]), out[0].numpy()
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        d = per_lane_diff(a, b)
        assert np.quantile(d, 0.85) <= 1e-9, np.sort(d)[-30:]
        spread = jax_one_ulp_spread(ray_case, bounds, carry, pin)
        assert d.max() <= 2 * spread.max(), (d.max(), spread.max())
        carry = tuple(x.numpy() for x in out[1:4])
        # Continue both from the port's carry so each group starts equal.


def test_pin_unreachable_is_bitwise_pin_off(ray_case):
    """Pin armed with unreachable thresholds == pin off, bitwise."""
    bgj, bgt, y0, h0 = ray_case
    rhs = tray.RayRHS(bgt)
    y = torch.as_tensor(y0)
    args = (rhs, y, torch.zeros(y.shape[1], dtype=torch.float64),
            torch.as_tensor(h0), rhs(y), torch.arange(1, 17,
                                                      dtype=torch.float64) * DT,
            1e-6, 1e-6, 7.2)
    off = trk.integrate_group_dense(*args)
    armed = trk.integrate_group_dense(*args, pin_limit=2 ** 20,
                                      pin_mwn=1e9)
    for a, b in zip(np_out(off), np_out(armed)):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# Synthetic lanes (tests/test_pin_kill.py): exact control over which lanes
# grind and when |y[3]| crosses pin_mwn.
# ---------------------------------------------------------------------------

OSC = 1.0e4
HARD = np.array([0., 0., 1., 1., 1., 1., 0., 0.])
GROW = np.array([0., 0., 400., -400., 0., 0., 0., 0.])
Y3_0 = np.array([0., 0., 30., -30., 0., 0., 60., -60.])
BOUNDS = np.array([0.01, 0.02, 0.03, 0.04, 0.05, 0.06, 0.07])


def osc_rhs(xp, hard, grow):
    def rhs(y, t=0.0):
        one = xp.ones_like(y[0])
        return xp.stack([one, hard * OSC * xp.cos(OSC * t) + (1.0 - hard),
                         one, grow * one, one])
    return rhs


@functools.cache
def run_osc(pkg, pin_limit=None, pin_mwn=None):
    """The synthetic lanes through one package (cached: several tests read
    the same runs)."""
    pin = {} if pin_limit is None else dict(pin_limit=pin_limit,
                                            pin_mwn=pin_mwn)
    y0 = np.zeros((5, 8))
    y0[3] = Y3_0
    if pkg == "jax":
        rhs = osc_rhs(jnp, jnp.asarray(HARD), jnp.asarray(GROW))
        y = jnp.asarray(y0)
        pin = {k: jnp.asarray(v, jnp.int32 if k == "pin_limit" else None)
               for k, v in pin.items()}
        return np_out(jrk.integrate_group_dense(
            rhs, y, jnp.zeros(8), jnp.full(8, 1e-2), rhs(y, jnp.zeros(8)),
            jnp.asarray(BOUNDS), 1e-6, 1e-8, 1e-3, **pin))
    rhs = osc_rhs(torch, torch.as_tensor(HARD), torch.as_tensor(GROW))
    y = torch.as_tensor(y0)
    t0 = torch.zeros(8, dtype=torch.float64)
    return np_out(trk.integrate_group_dense(
        rhs, y, t0, torch.full((8,), 1e-2, dtype=torch.float64), rhs(y, t0),
        torch.as_tensor(BOUNDS), 1e-6, 1e-8, 1e-3, **pin))


@pytest.mark.parametrize("pin", [(), (200, 50.0)])
def test_synthetic_lanes_match_jax(pin):
    ref, out = run_osc("jax", *pin), run_osc("torch", *pin)
    np.testing.assert_array_equal(np.isnan(ref[0]), np.isnan(out[0]))
    np.testing.assert_allclose(out[0], ref[0], rtol=1e-9, atol=1e-9)
    np.testing.assert_array_equal(ref[7], out[7])
    assert ref[5] == out[5]


def test_pin_retires_only_grinding_large_l_lanes():
    base = run_osc("torch")
    pin = run_osc("torch", 200, 50.0)
    hist_b, hist_p, la = base[0], pin[0], pin[7]
    assert np.isfinite(hist_b).all()
    for lane in (0, 1, 4, 5, 6, 7):
        np.testing.assert_array_equal(hist_b[..., lane], hist_p[..., lane])
    for lane in (2, 3):
        dead = np.isnan(hist_p[:, 0, lane])
        assert dead.any() and not dead[:4].any()
        np.testing.assert_array_equal(hist_b[~dead, :, lane],
                                      hist_p[~dead, :, lane])
        assert (np.diff(dead.astype(int)) >= 0).all()
    assert la[4] >= 200 and la[5] >= 200
    assert la[0] < 200 and la[7] < 200


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_pin_kills_perpetual_rejection_grinder_at_exactly_pin_limit(pkg):
    """A lane whose every trial is rejected is retired at EXACTLY
    lane_att == pin_limit, on a rejection at the step floor."""
    W, BIG = 1e24, 1e10
    xp = jnp if pkg == "jax" else torch
    hard = xp.asarray([0., 0., 1., 0.], dtype=xp.float64)

    def rhs(y, t=0.0):
        one = xp.ones_like(y[0])
        noise = BIG * xp.sin(W * xp.asarray(t, dtype=xp.float64)) * one
        return xp.stack([one, hard * noise + (1.0 - hard), one,
                         xp.zeros_like(one), one])

    y0 = xp.zeros((5, 4), dtype=xp.float64)
    t0 = xp.zeros(4, dtype=xp.float64)
    bounds = xp.asarray([0.01, 0.02, 0.03], dtype=xp.float64)
    args = (rhs, y0, t0, xp.full((4,), 1e-2, dtype=xp.float64), rhs(y0, t0),
            bounds, 1e-6, 1e-8, 1e-3)
    integrate = (jrk if pkg == "jax" else trk).integrate_group_dense
    pin = (dict(pin_limit=jnp.asarray(15, jnp.int32),
                pin_mwn=jnp.asarray(0.0)) if pkg == "jax"
           else dict(pin_limit=15, pin_mwn=0.0))
    off = np_out(integrate(*args, max_iters=2000))
    on = np_out(integrate(*args, max_iters=2000, **pin))
    assert int(off[5]) == 2000 and int(off[7][2]) == 2000
    assert float(off[2][2]) < 1e-10
    assert int(on[7][2]) == 15
    assert int(on[5]) <= 30
    assert np.isnan(on[0][:, 0, 2]).all()
    assert float(on[2][2]) == 0.03
    for lane in (0, 1, 3):
        np.testing.assert_array_equal(off[0][..., lane], on[0][..., lane])


def test_cpu_dense_group_has_no_kernel_launch(ray_case):
    before = trk.LAUNCHES
    run_both(ray_case, np.arange(1, 4) * DT, max_iters=2)
    assert trk.LAUNCHES == before
