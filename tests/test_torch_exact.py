"""Port parity: the exact-bound adaptive integrators (``solvers/rk45.py``
``integrate_interval``, ``group_entry_state``, ``integrate_group``;
``tracer._rk45_chunk``, ``_rk45_group_chunk``, ``_exact_run``,
``_run_rk45``).

On a CPU state the plain versions run; the CUDA kernels
(``csrc/exact_run.cu``) are held to them bitwise on the card
(tests/test_torch_cuda_kernels.py).

The batch: the ``jet_field`` background carried across with ``convert``, a
5 x 4 source grid plus three sources in the polar caps, zwn 2, 4, 6: 207
lanes, 72 rootless (tests/test_torch_dense_run.py's), float64.

Bars. Step-level parity is tight: the first trips, and runs of at most
one output bound, agree with the JAX package to 1e-12. Over whole runs the
adaptive controller amplifies round-off (XLA contracts FMAs, PyTorch
rounds each op), so runs are held to the adaptive bars of
tests/test_torch_rk45.py and test_torch_dense_run.py: NaN masks
identical, 85 % of the lanes within 1e-9 of scale, every lane within twice
the JAX package's own spread under one-ulp moves of the sources, read in
the same test. In the port alone the grouped path equals the barrier path
bitwise, as the JAX package's does.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import rwrt_tpu as rt
import rwrt_tpu_torch as pt
from rwrt_tpu import tracer as jtracer
from rwrt_tpu.models import ray as jray
from rwrt_tpu.solvers import rk45 as jrk
from rwrt_tpu_torch import convert
from rwrt_tpu_torch import tracer as ttracer
from rwrt_tpu_torch.models import ray as tray
from rwrt_tpu_torch.solvers import rk45 as trk

DT = 7200.0
RTOL = ATOL = 1e-6
MIN_STEP = 7.2
CUT_OFF = 0.2


@pytest.fixture(scope="module")
def batch(jet_field):
    u, v, lat, lon = jet_field
    bgj = jtracer.make_background(
        rt.prepare(u, v, lat, lon, cal_dtype="float64"), 0.0)
    bgt = convert.background_from_numpy(
        {k: np.asarray(x) for k, x in bgj._asdict().items() if x is not None},
        device="cpu")
    slon, slat = jtracer.source_matrix(0.0, 5.0, 36.0, 8.0, 5, 4)
    slon = np.concatenate([slon, np.radians([10.0, 100.0, 200.0])])
    slat = np.concatenate([slat, np.radians([86.0, 88.5, -87.0])])
    zwn = jnp.asarray([2.0, 4.0, 6.0])

    def init(lons, lats):
        return tuple(np.array(x) for x in jtracer.initialize(
            bgj, jnp.asarray(lons), jnp.asarray(lats), zwn))

    moved = [init(np.nextafter(slon, d), slat) for d in (np.inf, -np.inf)]
    moved += [init(slon, np.nextafter(slat, d)) for d in (np.inf, -np.inf)]
    return bgj, bgt, init(slon, slat), moved


def same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return (np.array_equal(np.isnan(a), np.isnan(b))
            and np.array_equal(np.nan_to_num(a), np.nan_to_num(b)))


def np_out(out):
    return [o.numpy() if torch.is_tensor(o) else np.asarray(o) for o in out]


def jax_fns(bgj):
    def rhs(yy, tt=0.0):
        return jray.rhs(bgj, yy, tt)[0]

    def rhs_gv(yy, tt=0.0):
        return jray.rhs_and_gv(bgj, yy, tt)
    return rhs, rhs_gv


def port_fns(bgt):
    return tray.RayRHS(bgt), lambda yy, tt=0.0: tray.rhs_and_gv(bgt, yy, tt)


def entry(bgt, y0):
    """(y, t, h, f, prev_lon, prev_lat) at t = 0 as numpy arrays."""
    y = torch.as_tensor(y0)
    h0 = ttracer.initial_step_sizes(bgt, y, RTOL, ATOL)
    return (y0, np.zeros(y0.shape[1]), h0.numpy(), tray.RayRHS(bgt)(y).numpy(),
            y0[0].copy(), y0[1].copy())


def close(a, b, bar, name):
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b), name)
    np.testing.assert_allclose(b, a, rtol=bar, atol=bar * np.nanmax(np.abs(a)),
                               err_msg=name)


def test_group_entry_state_matches_jax(batch):
    _, _, (y0, _, _), _ = batch
    y = np.array(y0)
    y[4, 5] = np.nan          # a NaN amp alone is not finished at entry
    bounds = np.arange(1, 8) * DT
    ref = jrk.group_entry_state(jnp.asarray(y), jnp.asarray(bounds))
    out = trk.group_entry_state(torch.as_tensor(y), torch.as_tensor(bounds))
    for a, b in zip(ref, np_out(out)):
        assert same(a, b)
    assert out[4][5] == 0 and (out[4].numpy() == 7).sum() == 72


@pytest.mark.parametrize("trips", [1, 2, 3])
def test_integrate_interval_first_trips_match_jax(batch, trips):
    bgj, bgt, (y0, _, _), _ = batch
    y, t, h, _, _, _ = entry(bgt, y0)
    jrhs, _ = jax_fns(bgj)
    ref = jrk.integrate_interval(
        jrhs, jnp.asarray(y), jnp.asarray(t), jnp.asarray(h),
        jnp.asarray(DT), RTOL, ATOL, jnp.asarray(MIN_STEP), max_iters=trips)
    out = trk.integrate_interval(
        tray.RayRHS(bgt), torch.as_tensor(y), torch.as_tensor(t),
        torch.as_tensor(h), DT, RTOL, ATOL, MIN_STEP, max_iters=trips)
    for i, name in ((0, "y"), (1, "t"), (2, "h")):
        close(ref[i], out[i].numpy(), 1e-12, name)
    assert int(ref[3]) == out[3] and int(ref[4]) == out[4]
    assert int(out[5].max()) == out[3]


def run_group(pkg, bgt, bgj, carry, bounds, max_iters=1_000_000,
              state0=None):
    """``integrate_group`` of one package from a numpy carry."""
    if pkg == "jax":
        rhs, rhs_gv = jax_fns(bgj)
        c = [jnp.asarray(x) for x in carry]
        return np_out(jrk.integrate_group(
            rhs, rhs_gv, *c[:4], jnp.asarray(bounds), *c[4:],
            jnp.asarray(CUT_OFF), jnp.asarray(RTOL), jnp.asarray(ATOL),
            jnp.asarray(MIN_STEP), max_iters=max_iters,
            state0=None if state0 is None else tuple(
                jnp.asarray(x) for x in state0)))
    rhs, rhs_gv = port_fns(bgt)
    c = [torch.as_tensor(x) for x in carry]
    return np_out(trk.integrate_group(
        rhs, rhs_gv, *c[:4], torch.as_tensor(bounds), *c[4:], CUT_OFF, RTOL,
        ATOL, MIN_STEP, max_iters=max_iters,
        state0=None if state0 is None else tuple(
            torch.as_tensor(x) for x in state0)))


GROUP_OUT = ("hist", "y", "t", "h", "f", "prev_lon", "prev_lat")


@pytest.mark.parametrize("trips", [1, 2, 3])
def test_integrate_group_first_trips_match_jax(batch, trips):
    bgj, bgt, (y0, _, _), _ = batch
    bounds = np.arange(1, 8) * DT
    carry = entry(bgt, y0)
    ref = run_group("jax", bgt, bgj, carry, bounds, max_iters=trips)
    out = run_group("torch", bgt, bgj, carry, bounds, max_iters=trips)
    for i, name in enumerate(GROUP_OUT):
        close(ref[i], out[i], 1e-12, name)
    assert int(ref[7]) == out[7]
    for i in (9, 10, 11, 12):
        np.testing.assert_array_equal(ref[i], out[i])


def per_lane_diff(ref, out, scales):
    """max over bounds and rows of |a - b| / scale, per lane, for the state
    rows and ug, vg."""
    return np.max([(np.nan_to_num(np.abs(a - b)) / s).max(axis=(0, 1))
                   for a, b, s in zip(ref, out, scales)], axis=0)


def rows(run):
    ys, ugs, vgs = (np.asarray(x) for x in run[:3])
    return ys, ugs[:, None], vgs[:, None]


def test_integrate_group_suspend_resume_is_bitwise(batch):
    """A group stopped after 5 trips and resumed from its returned state
    equals the uninterrupted group, bitwise; so does a resumed lane
    subset."""
    _, bgt, (y0, _, _), _ = batch
    bounds = np.arange(1, 8) * DT
    carry = entry(bgt, y0)
    whole = run_group("torch", bgt, None, carry, bounds)
    first = run_group("torch", bgt, None, carry, bounds, max_iters=5)
    assert (first[12] < 7).any()
    tail = [first[i] for i in (0, 10, 11, 9, 12)]
    rest = run_group("torch", bgt, None, first[1:7], bounds, state0=tail)
    for i in list(range(7)) + [9, 10, 11, 12]:
        assert same(whole[i], rest[i]), i
    assert int(whole[7]) == int(first[7]) + int(rest[7])
    sub = np.flatnonzero(first[12] < 7)[::2]
    part = run_group("torch", bgt, None, [x[..., sub] for x in first[1:7]],
                     bounds, state0=[x[..., sub] for x in tail])
    for i in list(range(7)) + [9, 12]:
        assert same(whole[i][..., sub], part[i]), i


@pytest.fixture(scope="module")
def barrier(batch):
    """The port's barrier path over 4 days (48 bounds) and its grouped
    path in groups of 7 (an uneven tail), from the same entry state."""
    _, bgt, (y0, _, _), _ = batch
    y, t, h, f, pl, pa = (torch.as_tensor(x) for x in entry(bgt, y0))
    bounds = torch.arange(1, 49, dtype=torch.float64) * DT
    (_, (ys_b, ug_b, vg_b, it_b, _, la_b, tr_b)) = ttracer._rk45_chunk(
        bgt, y, t, h, bounds, CUT_OFF, RTOL, ATOL, MIN_STEP)
    carry = (y, t, h, f, pl, pa)
    parts, iters_g = [], 0
    for i in range(0, 48, 7):
        carry, (hist, ug, vg, it, _, _) = ttracer._rk45_group_chunk(
            bgt, *carry, bounds[i:i + 7], CUT_OFF, RTOL, ATOL, MIN_STEP)
        parts.append((hist, ug, vg))
        iters_g += it
    grouped = [torch.cat(p) for p in zip(*parts)]
    return (ys_b, ug_b, vg_b), grouped, (int(it_b.sum()), iters_g,
                                         int(tr_b.sum()))


def test_grouped_equals_barrier_bitwise(barrier):
    """The port's version of test_grouped_intervals_equal_barrier."""
    ref, grouped, (it_b, it_g, trunc) = barrier
    for a, b in zip(ref, grouped):
        assert same(a, b)
    assert it_g <= it_b and trunc == 0
    ys = ref[0].numpy()
    assert np.isnan(ys[-1, 0]).any() and np.isfinite(ys[-1, 0]).any()


def test_amp_nan_lane_group_equals_barrier(batch):
    """A lane whose amp is NaN while its dynamics rows stay finite is
    walked bound by bound: state unchanged, finite (ug, vg), equal to the
    barrier path's (static background)."""
    _, bgt, (y0, _, _), _ = batch
    y0 = np.array(y0)
    born = np.flatnonzero(np.isfinite(y0[4]))
    y0[4, born[[0, 2]]] = np.nan
    y, t, h, f, pl, pa = (torch.as_tensor(x) for x in entry(bgt, y0))
    bounds = torch.arange(1, 13, dtype=torch.float64) * DT
    _, (ys_b, ug_b, vg_b, _, _, _, _) = ttracer._rk45_chunk(
        bgt, y, t, h, bounds, CUT_OFF, RTOL, ATOL, MIN_STEP)
    carry, parts, atts = (y, t, h, f, pl, pa), [], []
    for i in range(0, 12, 5):
        carry, (hist, ug, vg, _, _, la) = ttracer._rk45_group_chunk(
            bgt, *carry, bounds[i:i + 5], CUT_OFF, RTOL, ATOL, MIN_STEP)
        parts.append((hist, ug, vg))
        atts.append(la)
    for a, b in zip((ys_b, ug_b, vg_b), (torch.cat(p) for p in zip(*parts))):
        assert same(a, b)
    lane = born[0]
    assert (ys_b[:, 0, lane] == float(y0[0, lane])).all()
    assert torch.isfinite(ug_b[:, lane]).all()
    assert all(int(la[lane]) == 0 for la in atts)


EXACT_CASES = {
    "default": dict(cut_off=CUT_OFF, max_iters=1_000_000),
    "cutoff": dict(cut_off=0.03, max_iters=1_000_000),
    "maxiters": dict(cut_off=CUT_OFF, max_iters=3),
}


def port_run(bgt, seeds, case, nt=13, group=5):
    return ttracer._run_rk45_grouped(
        bgt, *(torch.as_tensor(x) for x in seeds), DT, nt, case["cut_off"],
        RTOL, ATOL, MIN_STEP, group=group, max_iters=case["max_iters"])


def jax_run(bgj, seeds, case, nt=13, group=5):
    out = jtracer._run_rk45_grouped(
        bgj, *(jnp.asarray(x) for x in seeds), jnp.asarray(DT), nt,
        jnp.asarray(case["cut_off"]), jnp.asarray(RTOL), jnp.asarray(ATOL),
        jnp.asarray(MIN_STEP), group=group, dense=False,
        max_iters=case["max_iters"])
    return [np.asarray(x) for x in out]


@pytest.fixture(scope="module")
def jax_spread(batch):
    """Row scales of the default case, and the JAX package's per-lane
    spread against itself: the largest difference over four one-ulp moves
    of the sources (lon up and down, lat up and down). Exact mode amplifies
    round-off far less than dense mode, so one move is a poor sample of
    the spread: over these 12 bounds its largest lane differs by 1.3e-12 of
    scale for lon up and 3.7e-11 for lat up."""
    bgj, _, seeds, moved = batch
    ref = jax_run(bgj, seeds, EXACT_CASES["default"])
    scales = [np.nanmax(np.abs(a), axis=(0, 2))[None, :, None]
              for a in rows(ref)]
    return scales, np.max([
        per_lane_diff(rows(ref), rows(jax_run(bgj, m, EXACT_CASES["default"])),
                      scales) for m in moved], axis=0)


@pytest.mark.parametrize("name", list(EXACT_CASES))
def test_exact_run_matches_jax(batch, jax_spread, name):
    """The grouped exact run (12 bounds in groups of 5, the last padded):
    NaN masks identical; 85 % of the lanes within 1e-9 of each row's scale
    and every lane within twice the JAX package's one-ulp spread (the
    max_iters case, a few trips long, within 1e-12); the truncation count
    equal."""
    bgj, bgt, seeds, _ = batch
    scales, spread = jax_spread
    case = EXACT_CASES[name]
    ref = jax_run(bgj, seeds, case)
    out = np_out(port_run(bgt, seeds, case))
    for a, b, what in zip(rows(ref), rows(out), ("rows", "ug", "vg")):
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b), what)
    assert int(ref[5]) == out[5]
    d = per_lane_diff(rows(ref), rows(out), scales)
    if name == "maxiters":
        assert out[5] > 0 and d.max() <= 1e-12, (out[5], d.max())
        return
    assert out[5] == 0
    assert np.quantile(d, 0.85) <= 1e-9, np.sort(d)[-30:]
    assert d.max() <= 2 * spread.max(), (d.max(), spread.max())
    if name == "cutoff":
        killed = np.isnan(out[0][-1, 0]) & np.isfinite(seeds[0][3])
        assert killed.any()


def test_one_bound_groups_equal_the_barrier_run_bitwise(batch):
    """What the card runs for interval_batch 1 (the exact run with one
    bound per group, max_iters 100,000, the barrier flag) equals the
    barrier path ``_run_rk45`` runs on the CPU, rows, attempts and
    truncation count."""
    _, bgt, seeds, _ = batch
    y0, ug0, vg0 = (torch.as_tensor(x) for x in seeds)
    barrier = ttracer._run_rk45(bgt, y0, ug0, vg0, DT, 13, CUT_OFF, RTOL,
                                ATOL, MIN_STEP)
    h0 = ttracer.initial_step_sizes(bgt, y0, RTOL, ATOL)
    run = ttracer._exact_run(
        bgt, y0, ug0, vg0, h0, tray.RayRHS(bgt)(y0),
        ttracer.padded_bounds(DT, 13, 1, torch.float64, "cpu"), 12, CUT_OFF,
        RTOL, ATOL, MIN_STEP, 100_000, barrier=True)
    grouped = ttracer._run_outputs(run)
    for i in range(3):
        assert same(barrier[i], grouped[i]), i
    assert torch.equal(barrier[6], grouped[6])
    assert barrier[5] == grouped[5] == 0


def test_max_iters_truncation_raises_from_both_runners(batch):
    """Both exact runners count the lanes a tiny max_iters leaves short
    while alive, and ``_check_truncation`` raises for them."""
    _, bgt, seeds, _ = batch
    y0, ug0, vg0 = (torch.as_tensor(x) for x in seeds)
    args = (bgt, y0, ug0, vg0, DT, 13, CUT_OFF, RTOL, ATOL, MIN_STEP)
    grouped = ttracer._run_rk45_grouped(*args, group=5, max_iters=2)
    barrier = ttracer._run_rk45(*args, max_iters=2)
    for out in (grouped, barrier):
        assert out[5] > 0
        with pytest.raises(ttracer.MaxItersTruncation):
            ttracer._check_truncation(out[5])


def test_exact_run_lane_subset_equals_full_batch_bitwise(batch):
    _, bgt, seeds, _ = batch
    y0, ug0, vg0 = (torch.as_tensor(x) for x in seeds)
    h0 = ttracer.initial_step_sizes(bgt, y0, RTOL, ATOL)
    f0 = tray.RayRHS(bgt)(y0)
    bounds_g = ttracer.padded_bounds(DT, 13, 5, torch.float64, "cpu")

    def run(idx):
        return ttracer._exact_run(
            bgt, y0[:, idx].contiguous(), ug0[idx], vg0[idx], h0[idx],
            f0[:, idx].contiguous(), bounds_g, 12, 0.03, RTOL, ATOL,
            MIN_STEP)

    every = torch.arange(y0.shape[1])
    sub = torch.cat([every[1::3], every[-9:]])
    full, part = run(every), run(sub)
    for a, b in zip(full[:5], part[:5]):
        assert same(a[..., sub], b)
    for a, b in zip(full.carry, part.carry):
        assert same(a[..., sub], b)


def test_pin_is_refused_in_exact_mode(batch):
    _, bgt, seeds, _ = batch
    with pytest.raises(ValueError):
        ttracer._run_rk45_grouped(
            bgt, *(torch.as_tensor(x) for x in seeds), DT, 13, CUT_OFF,
            RTOL, ATOL, MIN_STEP, group=5, pin_limit=500, pin_mwn=0.0)


def test_cpu_exact_has_no_kernel_launch(batch):
    _, bgt, seeds, _ = batch
    before = (ttracer.EXACT_LAUNCHES, trk.EXACT_LAUNCHES, tray.LAUNCHES)
    port_run(bgt, seeds, EXACT_CASES["maxiters"])
    assert (ttracer.EXACT_LAUNCHES, trk.EXACT_LAUNCHES,
            tray.LAUNCHES) == before


TRACE_CFG = dict(zwn=(2.0, 4.0, 6.0), sw_lon=0.0, sw_lat=5.0, dlon=36.0,
                 dlat=8.0, nnx=5, nny=4, tstep=DT, cal_dtype="float64",
                 integrator="rk45", bound_mode="exact")


@pytest.fixture(scope="module")
def trace_states(jet_field):
    u, v, lat, lon = jet_field
    bsj = rt.prepare(u, v, lat, lon, cal_dtype="float64")
    return bsj, convert.basic_state_from_numpy(
        {k: np.asarray(x) for k, x in bsj._asdict().items()}, device="cpu")


def trace_rows(traj):
    """(nt, 5, R) state rows and (nt, 1, R) ug, vg of a trajectory."""
    f = [np.asarray(getattr(traj, k)) for k in traj._fields]
    nt = f[0].shape[0]
    return (np.stack([x.reshape(nt, -1) for x in f[:5]], axis=1),
            f[5].reshape(nt, 1, -1), f[6].reshape(nt, 1, -1))


@pytest.fixture(scope="module")
def trace_spread(trace_states):
    """The 4-day run's row scales and the JAX package's per-lane spread
    over four one-ulp moves of the sources."""
    bsj, _ = trace_states
    cfg = rt.RunConfig(**dict(TRACE_CFG, ttotal=4 * 86400.0))
    slon, slat = (np.asarray(x) for x in jtracer.source_matrix(
        cfg.sw_lon, cfg.sw_lat, cfg.dlon, cfg.dlat, cfg.nnx, cfg.nny))
    ref = trace_rows(rt.trace_rays(bsj, cfg))
    scales = [np.nanmax(np.abs(a), axis=(0, 2))[None, :, None] for a in ref]
    moves = [(np.nextafter(slon, d), slat) for d in (np.inf, -np.inf)]
    moves += [(slon, np.nextafter(slat, d)) for d in (np.inf, -np.inf)]
    return scales, np.max([per_lane_diff(ref, trace_rows(rt.trace_rays(
        bsj, cfg, source_lon=lo, source_lat=la)), scales)
        for lo, la in moves], axis=0)


@pytest.mark.parametrize("batch_size", [16, 1])
@pytest.mark.parametrize("days", [0.05, 1 / 12, 4])
def test_trace_rays_matches_jax(trace_states, trace_spread, batch_size,
                                days):
    """nt = 1, 2 and 49, grouped (interval_batch 16) and bound by bound
    (interval_batch 1): NaN masks identical; within 1e-12 of scale up to
    one bound, else the run bars above; rootless lanes frozen at their
    seed rows; lane_att in ``stats``."""
    bsj, bst = trace_states
    cfg = dict(TRACE_CFG, ttotal=days * 86400.0, interval_batch=batch_size)
    ref = trace_rows(rt.trace_rays(bsj, rt.RunConfig(**cfg)))
    stats = {}
    traj = pt.trace_rays(bst, pt.RunConfig(**cfg), stats=stats)
    out = trace_rows(traj)
    nt = ref[0].shape[0]
    assert traj.lon.shape == (nt, 3, 20, 3)
    for a, b in zip(ref, out):
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    scales, spread = trace_spread
    d = per_lane_diff(ref, out, scales)
    if nt <= 2:
        assert d.max() <= 1e-12, d.max()
    else:
        assert np.quantile(d, 0.85) <= 1e-9, np.sort(d)[-30:]
        assert d.max() <= 2 * spread.max(), (d.max(), spread.max())
    rootless = np.isnan(out[0][0, 3])
    assert rootless.any()
    assert same(out[0][:, :, rootless],
                np.broadcast_to(out[0][0, :, rootless].T,
                                out[0][:, :, rootless].shape))
    # One group per bound off the grouped path; 126 born lanes padded to 8.
    grouped = batch_size > 1 and nt > 2
    n_groups = -(-(nt - 1) // batch_size) if grouped else nt - 1
    assert tuple(stats["lane_att"].shape) == (n_groups, 128)


@pytest.fixture(scope="module", params=["float64", "float32"])
def overflow_batch(jet_field, request):
    """The 5 x 4 source grid at zwn 2, 4, 6 in ``request.param``, every born
    lane's amp set to the dtype's largest value: its growth overflows the
    amp to inf, then NaN, inside the first interval while the dynamics
    stay finite. Returns (JAX background, port background, y0, ug0, vg0,
    born lane indices)."""
    u, v, lat, lon = jet_field
    dtype = request.param
    bgj = jtracer.make_background(
        rt.prepare(u, v, lat, lon, cal_dtype=dtype), 0.0)
    bgt = convert.background_from_numpy(
        {k: np.asarray(x) for k, x in bgj._asdict().items() if x is not None},
        device="cpu")
    slon, slat = jtracer.source_matrix(0.0, 5.0, 36.0, 8.0, 5, 4)
    y0, ug0, vg0 = (np.array(x) for x in jtracer.initialize(
        bgj, jnp.asarray(slon, dtype), jnp.asarray(slat, dtype),
        jnp.asarray([2.0, 4.0, 6.0], dtype)))
    born = np.flatnonzero(np.isfinite(y0[4]))
    y0[4, born] = np.finfo(y0.dtype).max
    return bgj, bgt, y0, ug0, vg0, born


#: Bars of the one-bound runs against the JAX barrier path over 3 bounds,
#: of each row's scale: float64 round-off (1e-12, as the step-level tests);
#: in float32 the RHS's own bar against the plain version (1e-5, as
#: chip_smoke's), since XLA contracts FMAs. The unflagged run leaves them
#: by orders of magnitude: it misses the overflowed lanes' last steps.
OVERFLOW_BARS = {np.dtype("float64"): 1e-12, np.dtype("float32"): 1e-5}


def test_one_bound_barrier_run_matches_jax_on_amp_overflow(overflow_batch):
    """What the card runs for interval_batch 1 (one bound per group, the
    barrier flag) keeps stepping a lane whose amp turns NaN inside an
    interval, as the JAX package's barrier path ``_run_rk45`` does: every
    row within the bars. Without the flag the grouped semantics walk that
    lane to the bound frozen, and its rows leave the bars: the fault the
    flag repairs. On the CPU the port's barrier path equals the flagged run
    bitwise."""
    bgj, bgt, y0, ug0, vg0, born = overflow_batch
    nt, bar = 4, OVERFLOW_BARS[y0.dtype]
    dt = y0.dtype.name
    ref = [np.asarray(x) for x in jtracer._run_rk45(
        bgj, *(jnp.asarray(x) for x in (y0, ug0, vg0)), jnp.asarray(DT, dt),
        nt, jnp.asarray(CUT_OFF, dt), jnp.asarray(RTOL, dt),
        jnp.asarray(ATOL, dt), jnp.asarray(MIN_STEP, dt))]
    assert np.isnan(ref[0][1, 4, born]).any()
    assert np.isfinite(ref[0][1, :4, born]).any()
    y, ug, vg = (torch.as_tensor(x) for x in (y0, ug0, vg0))
    rtol = trk.validate_tol(RTOL, y.dtype)
    args = (bgt, y, ug, vg, ttracer.initial_step_sizes(bgt, y, rtol, ATOL),
            tray.RayRHS(bgt)(y),
            ttracer.padded_bounds(DT, nt, 1, y.dtype, "cpu"), nt - 1,
            CUT_OFF, rtol, ATOL, MIN_STEP, 100_000)
    flagged = ttracer._exact_run_plain(*args, barrier=True)
    grouped = ttracer._exact_run_plain(*args)
    scales = [np.nanmax(np.abs(a), axis=(0, 2))[None, :, None]
              for a in rows(ref)]
    for out, within in ((flagged, True), (grouped, False)):
        got = rows(np_out(out[:3]))
        for a, b in zip(rows(ref), got):
            np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        d = per_lane_diff(rows(ref), got, scales)
        assert (d.max() <= bar) == within, (within, d.max())
    barrier = ttracer._run_rk45(bgt, y, ug, vg, DT, nt, CUT_OFF, rtol, ATOL,
                                MIN_STEP)
    for a, b in zip(barrier[:3], flagged[:3]):
        assert same(a, b)
    assert torch.equal(barrier[6], flagged.lane_att)
