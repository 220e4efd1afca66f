"""The RK45 re-run of ``termination.cause_labels`` with a bound per lane
(``solvers/rk45.py`` ``integrate_interval``, ``integrate_interval_rays``).

On the card ``integrate_interval_rays`` is one launch of the interval
kernel (``csrc/interval.cu``): each lane loops to its own bound in
registers, capped at ``max_iters`` of its own trips. That equals the plain
loop, whose trip count is batch-wide, because a lane that is not done is
active on every trip: each lane ends after min(its own trips, max_iters)
trips whatever the other lanes do. (i) holds that property on the plain
loop, bitwise: a lane of a batch with per-lane times and bounds equals the
lane run alone, at caps that bind and at one that does not. (ii) holds
the port's loop to the JAX package's with per-lane time and bound vectors
at the step-level bar of tests/test_torch_exact.py (1e-12). (iii) the new
entry on a CPU state is the plain loop over ``ray._rhs_core``, and
``cause_labels`` through it counts the causes as the JAX package's
``classify`` does, over a static and a time-varying background. The
kernel itself is held to the plain loop on the card
(tests/test_torch_cuda_kernels.py). Float64 throughout; the inputs come
from numpy seeds.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import rwrt_tpu as rt
import rwrt_tpu_torch as pt
from rwrt_tpu import tracer as jtracer
from rwrt_tpu.diagnostics import termination as jterm
from rwrt_tpu.models import ray as jray
from rwrt_tpu.solvers import rk45 as jrk
from rwrt_tpu_torch import convert
from rwrt_tpu_torch import tracer as ttracer
from rwrt_tpu_torch.diagnostics import termination as pterm
from rwrt_tpu_torch.models import ray as tray
from rwrt_tpu_torch.solvers import rk45 as trk

HOUR, DAY = 3600.0, 86400.0
DT = 2 * HOUR
RTOL = ATOL = 1e-6
MIN_STEP = 7.2
#: Trip caps: two that bind on some lanes and one that binds on none.
CAPS = [3, 17, 10_000]
#: Lanes of the most and of the fewest trips each run alone at each cap.
ALONE = 4


def frames(u, v, nt=5):
    """nt wind frames a day apart: the jet's amplitude varies and the wave
    drifts east, frame by frame."""
    fu = np.stack([(1.0 + 0.15 * np.sin(k)) * u for k in range(nt)])
    fv = np.stack([np.roll(v, 2 * k, axis=0) for k in range(nt)])
    return fu, fv


def jax_state(field, kind):
    u, v, lat, lon = field
    if kind == "time":
        fu, fv = frames(u, v)
        return rt.prepare_time_varying(fu, fv, lat, lon, bg_t0=0.0,
                                       bg_dt=DAY, cal_dtype="float64")
    return rt.prepare(u, v, lat, lon, cal_dtype="float64")


def port_state(bs):
    return convert.basic_state_from_numpy(
        {k: np.asarray(x) for k, x in bs._asdict().items()}, device="cpu")


@pytest.fixture(scope="module", params=["static", "time"])
def lanes(request, jet_field):
    """(JAX background, port background, y, t0, h0, bound) as numpy: 180
    seeded lanes over the jet (5 x 4 sources x zwn 2, 4, 6 x 3 roots;
    rootless ones NaN), each with its own start in the first 3 days and an interval of
    1 to 12 output steps; one lane already at its bound, one past it, one
    with a NaN lon; h0 from the Hairer initial step at each lane's t0."""
    bs = jax_state(jet_field, request.param)
    bgj = jtracer.make_background(bs, 0.0)
    bgt = ttracer.make_background(port_state(bs), 0.0)
    slon, slat = jtracer.source_matrix(0.0, 20.0, 60.0, 8.0, 5, 4)
    y0, _, _ = jtracer.initialize(bgj, jnp.asarray(slon),
                                  jnp.asarray(slat),
                                  jnp.asarray([2.0, 4.0, 6.0]))
    y = np.array(y0)
    r = y.shape[1]
    rng = np.random.default_rng(13)
    t0 = rng.uniform(0.0, 3 * DAY, r)
    bound = t0 + rng.integers(1, 13, r) * DT
    live = np.flatnonzero(np.isfinite(y.mean(0)))
    bound[live[0]] = t0[live[0]]
    bound[live[1]] = t0[live[1]] - DT
    y[0, live[2]] = np.nan

    def rhs(yy, tt=0.0):
        return tray._rhs_core(bgt, yy, tt, False)[0]

    yt, tt = torch.as_tensor(y), torch.as_tensor(t0)
    h0 = trk.select_initial_step(rhs, yt, rhs(yt, tt), RTOL, ATOL, tt)
    return bgj, bgt, y, t0, h0.numpy(), bound


def same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return (np.array_equal(np.isnan(a), np.isnan(b))
            and np.array_equal(np.nan_to_num(a), np.nan_to_num(b)))


def plain_run(bgt, y, t0, h0, bound, cap):
    out = trk._integrate_interval_plain(
        bgt, *(torch.as_tensor(x) for x in (y, t0, h0, bound)), RTOL, ATOL,
        MIN_STEP, max_iters=cap)
    return [o.numpy() if torch.is_tensor(o) else o for o in out]


@pytest.mark.parametrize("cap", CAPS)
def test_each_lane_ends_as_if_alone(lanes, cap):
    """The batch-wide loop with per-lane times and bounds equals each lane
    run alone, bitwise, at the same cap: the property that lets one launch
    cap each lane at its own trips. Checked alone: the lanes at and past
    their bound and the one with a NaN lon, the ALONE lanes of the batch's
    most trips (at a binding cap, lanes it stopped) and the ALONE of its
    fewest trips above none."""
    _, bgt, y, t0, h0, bound = lanes
    batch = plain_run(bgt, y, t0, h0, bound, cap)
    att = batch[5]
    if cap < CAPS[-1]:
        assert (att == cap).any() and (att < cap).any(), att
    else:
        assert att.max() < cap and batch[3] == att.max()
    order = np.argsort(att, kind="stable")
    moved = order[att[order] > 0]
    special = np.flatnonzero((bound <= t0) | np.isnan(y[0]))
    for j in sorted({*special, *order[-ALONE:], *moved[:ALONE]}):
        lane = [x[..., j:j + 1] for x in (y, t0, h0, bound)]
        alone = plain_run(bgt, *lane, cap)
        for i in (0, 1, 2):
            assert same(batch[i][..., j:j + 1], alone[i]), (j, i)
        assert att[j] == alone[5][0] == alone[3], j


@pytest.mark.parametrize("cap", [1, 2])
def test_per_lane_bounds_match_jax(lanes, cap):
    """The port's integrate_interval against the JAX package's with
    per-lane t0 and bound vectors and a binding cap: the step-level bar."""
    bgj, bgt, y, t0, h0, bound = lanes

    def jrhs(yy, tt=0.0):
        return jray.rhs(bgj, yy, tt)[0]

    ref = jrk.integrate_interval(
        jrhs, *(jnp.asarray(x) for x in (y, t0, h0, bound)), RTOL, ATOL,
        jnp.asarray(MIN_STEP), max_iters=cap)
    out = plain_run(bgt, y, t0, h0, bound, cap)
    for i, name in ((0, "y"), (1, "t"), (2, "h")):
        a, b = np.asarray(ref[i]), out[i]
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b), name)
        np.testing.assert_allclose(
            b, a, rtol=1e-12, atol=1e-12 * np.nanmax(np.abs(a)),
            err_msg=name)
    assert int(ref[3]) == out[3] == cap


def test_entry_on_cpu_is_the_plain_loop(lanes):
    """``integrate_interval_rays`` on a CPU state: ``integrate_interval``
    over ``ray._rhs_core``, bitwise, with a scalar bound as with a
    vector."""
    _, bgt, y, t0, h0, bound = lanes

    def rhs(yy, tt=0.0):
        return tray._rhs_core(bgt, yy, tt, False)[0]

    for tb in (bound, float(bound.max())):
        args = [torch.as_tensor(x) for x in (y, t0, h0)]
        got = trk.integrate_interval_rays(bgt, *args, tb, RTOL, ATOL,
                                          MIN_STEP, max_iters=40)
        want = trk.integrate_interval(rhs, *args, tb, RTOL, ATOL, MIN_STEP,
                                      max_iters=40)
        for a, b in zip(got, want):
            assert (same(a, b) if torch.is_tensor(a) else a == b)


#: tests/test_torch_classify.py's critical-line workload in RK45.
CFG = dict(zwn=(1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 7.0), sw_lon=0.0,
           sw_lat=-50.0, dlon=60.0, dlat=12.0, nnx=6, nny=8, tstep=DT,
           cal_dtype="float64", integrator="rk45", ttotal=20 * DAY,
           cut_off=0.1)


@pytest.fixture(scope="module")
def critical_line_field():
    """Jets + tropical easterlies (tests/test_torch_classify.py's): rays die
    at the critical line, by a jump or at the pole."""
    nlon, nlat = 72, 37
    lat = np.linspace(-np.pi / 2, np.pi / 2, nlat)
    lon = np.arange(nlon) * 2 * np.pi / nlon
    u = (
        -28.0 * np.cos(lat)[None, :] ** 2 * np.cos(2 * lat)[None, :]
        + 30.0 * np.exp(-(((np.degrees(lat)[None, :] - 40.0) / 10.0) ** 2))
        + 25.0 * np.exp(-(((np.degrees(lat)[None, :] + 45.0) / 10.0) ** 2))
        + 6.0 * np.cos(3 * lon)[:, None] * np.cos(lat)[None, :] ** 2
    )
    v = 5.0 * np.sin(2 * lon)[:, None] * np.cos(lat)[None, :]
    return u, v, lat, lon


@pytest.mark.parametrize("kind", ["static", "time"])
def test_cause_labels_through_the_entry_count_as_jax(critical_line_field,
                                                     kind):
    """``classify`` (``cause_labels`` through ``integrate_interval_rays``)
    on the JAX package's trajectory: the cause counts of the JAX package's
    ``classify``; the labels equal those of the plain RHS callable (the
    plain loop), and ``stats`` holds the re-run's state and trips."""
    bs = jax_state(critical_line_field, kind)
    cfg = rt.RunConfig(**CFG)
    traj = rt.trace_rays(bs, cfg)
    pbs = port_state(bs)
    pcfg = pt.RunConfig(**CFG)
    ptraj = convert.trajectories_from_numpy(
        {k: np.asarray(x) for k, x in traj._asdict().items()}, device="cpu")
    want = jterm.classify(traj, bs, cfg)
    got = pterm.classify(ptraj, pbs, pcfg)
    assert got.counts == want.counts
    assert got.counts["runaway"] + got.counts["jump"] > 0, got.counts
    death = got.death_step
    stats = {}
    labels = pterm.cause_labels(ptraj, pbs, pcfg, death, stats=stats)
    plain = pterm.cause_labels(
        ptraj, pbs, pcfg, death,
        rhs=lambda bg, y, t: tray._rhs_core(bg, y, t, False)[:2])
    np.testing.assert_array_equal(labels, plain)
    n = labels.size
    assert stats["state"].shape == (5, n)
    assert stats["lane_att"].shape == (n,) and int(stats["lane_att"].max()) > 0
