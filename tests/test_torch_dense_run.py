"""Port parity: the whole dense adaptive run, ``tracer._dense_run``.

On a CPU state ``_dense_run`` runs its plain version, the one the whole-run
CUDA kernel (``csrc/dense_run.cu``) is held against on the card. Here it is
held

- to the bit against the group loop the port ran before that kernel
  (``integrate_group_dense`` and ``_dense_postpass`` per group, the
  histories concatenated), written out below as ``group_loop``;
- against the JAX package's ``_run_rk45_grouped(dense=True)`` under the
  parity bars of ROADMAP Queue 3: NaN masks of the rows, ug and vg
  identical at every output step; 85 % of the lanes within 1e-9 of each
  row's scale; every lane within twice the JAX package's own largest
  spread under a one-ulp move of the source longitudes (pin case, read in
  the same run). Scales and spread come from the pin case for every case:
  a kill only turns a lane's later rows NaN, so the rows left are the pin
  case's. With max_iters = 3 the runs are a few trips long and held to
  1e-12;
- to the bit between a subset of lanes and the same lanes of the full
  batch (lanes are independent; chip_smoke relies on it).

The batch: the ``jet_field`` background carried across with ``convert``, a
5 x 4 source grid plus three sources in the polar caps (86, 88.5 and -87
degrees), zwn 2, 4, 6: 207 lanes, 72 of them rootless, so frozen at their
seed state. 12 output intervals in groups of 5, so the last group is
padded. Cases: pin (500, 0) and pin off at the default cut_off (0.2 rad per
2 h step); cut_off 0.03 rad, which kills lanes at bounds inside groups; and
max_iters 3, which leaves lanes short (truncation).

The |lat| >= pi/2 arm of the kill test is not reached by any lane: the ray
RHS flags |lat| >= pi/2 and returns NaN there, and the polar cap
(|cos lat| <= 0.0175) zeroes the fields so a lane stops short of the pole,
so a row past the pole comes out NaN and dies by the NaN rule. The polar
lanes here stay alive in the cap in both packages.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import rwrt_tpu as rt
from rwrt_tpu import tracer as jtracer
from rwrt_tpu_torch import convert
from rwrt_tpu_torch import tracer as ttracer
from rwrt_tpu_torch.models import ray as tray
from rwrt_tpu_torch.solvers import rk45 as trk

DT = 7200.0
NT = 13
GROUP = 5
RTOL = ATOL = 1e-6
MIN_STEP = 7.2

CASES = {
    "pin": dict(cut_off=0.2, pin=(500, 0.0), max_iters=1_000_000),
    "nopin": dict(cut_off=0.2, pin=None, max_iters=1_000_000),
    "cutoff": dict(cut_off=0.03, pin=(500, 0.0), max_iters=1_000_000),
    "maxiters": dict(cut_off=0.2, pin=(500, 0.0), max_iters=3),
}


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

    def init(lons):
        return tuple(np.array(x) for x in jtracer.initialize(
            bgj, jnp.asarray(lons), jnp.asarray(slat), zwn))

    return bgj, bgt, init(slon), init(np.nextafter(slon, np.inf))


def port_run(bgt, y0, ug0, vg0, case):
    """The port's grouped runner: set-up, then ``_dense_run``."""
    pin = case["pin"]
    return ttracer._run_rk45_grouped(
        bgt, *(torch.as_tensor(x) for x in (y0, ug0, vg0)), DT, NT,
        case["cut_off"], RTOL, ATOL, MIN_STEP, group=GROUP, dense=True,
        pin_limit=None if pin is None else pin[0],
        pin_mwn=None if pin is None else pin[1],
        max_iters=case["max_iters"])


def jax_run(bgj, y0, ug0, vg0, case):
    pin = case["pin"]
    kw = {} if pin is None else dict(pin_limit=jnp.asarray(pin[0], jnp.int32),
                                     pin_mwn=jnp.asarray(pin[1]))
    out = jtracer._run_rk45_grouped(
        bgj, *(jnp.asarray(x) for x in (y0, ug0, vg0)), jnp.asarray(DT), NT,
        jnp.asarray(case["cut_off"]), jnp.asarray(RTOL), jnp.asarray(ATOL),
        jnp.asarray(MIN_STEP), group=GROUP, dense=True,
        max_iters=case["max_iters"], **kw)
    return [np.asarray(x) for x in out]


def group_loop(bg, y0, ug0, vg0, dt, nt, cut_off, rtol, atol, min_step,
               group, pin_limit, pin_mwn, max_iters):
    """The port's grouped dense run before the whole-run kernel: one
    ``integrate_group_dense`` and one ``_dense_postpass`` per group, the
    per-group histories concatenated, y0 prepended."""
    rhs_fn = tray.RayRHS(bg)
    h0 = ttracer.initial_step_sizes(bg, y0, rtol, atol)
    t0 = torch.zeros_like(y0[0])
    f0 = rhs_fn(y0, t0)
    n_bounds = nt - 1
    n_groups = -(-n_bounds // group)
    bounds_all = torch.arange(1, n_groups * group + 1,
                              dtype=y0.dtype) * dt
    bounds_g = torch.clamp(bounds_all, max=(nt - 1) * dt).reshape(
        n_groups, group)
    assert torch.equal(bounds_g, ttracer.padded_bounds(dt, nt, group,
                                                       y0.dtype, "cpu"))
    y, t, h, f, pl, pa = y0, t0, h0, f0, y0[0], y0[1]
    hists, ugss, vgss, iters, truncs = [], [], [], [], []
    for bounds in bounds_g:
        nan0 = torch.isnan(torch.mean(y, dim=0))
        hist, y2, t2, h2, f2, it, _, _, _, _ = trk.integrate_group_dense(
            rhs_fn, y, t, h, f, bounds, rtol, atol, min_step,
            max_iters=max_iters, pin_limit=pin_limit, pin_mwn=pin_mwn)
        truncs.append(torch.sum((t2 < bounds[-1]) & ~torch.isnan(y2[0])))
        (y, t, h, f, pl, pa), (hist, ugs, vgs) = ttracer._dense_postpass(
            bg, hist, y2, t2, h2, f2, pl, pa, cut_off, nan0)
        hists.append(hist)
        ugss.append(ugs)
        vgss.append(vgs)
        iters.append(it)
    ys = torch.cat([y0[None], torch.cat(hists)[:n_bounds]])
    ugs = torch.cat([ug0[None], torch.cat(ugss)[:n_bounds]])
    vgs = torch.cat([vg0[None], torch.cat(vgss)[:n_bounds]])
    return ys, ugs, vgs, iters, int(torch.stack(truncs).sum())


def same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return (np.array_equal(np.isnan(a), np.isnan(b))
            and np.array_equal(np.nan_to_num(a), np.nan_to_num(b)))


def rows_of(run):
    """The state rows, ug and vg of a run as (nt, rows, R) arrays."""
    return run[0], run[1][:, None], run[2][:, None]


def scales_of(run):
    return [np.nanmax(np.abs(a), axis=(0, 2))[None, :, None]
            for a in rows_of(run)]


def per_lane_diff(ref, out, scales):
    """max over output steps and rows of |a - b| / scale, per lane, for the
    state rows and ug, vg."""
    return np.max([(np.nan_to_num(np.abs(a - b)) / s).max(axis=(0, 1))
                   for a, b, s in zip(rows_of(ref), rows_of(out), scales)],
                  axis=0)


@pytest.fixture(scope="module")
def jax_spread(batch):
    """The pin case's row scales, and the JAX package's per-lane spread
    against itself with the source longitudes moved by one ulp."""
    bgj, _, seeds, seeds_ulp = batch
    ref = jax_run(bgj, *seeds, CASES["pin"])
    scales = scales_of(ref)
    return scales, per_lane_diff(ref, jax_run(bgj, *seeds_ulp, CASES["pin"]),
                                 scales)


@pytest.mark.parametrize("name", list(CASES))
def test_dense_run_equals_the_group_loop_bitwise(batch, name):
    _, bgt, (y0, ug0, vg0), _ = batch
    case = CASES[name]
    pin = case["pin"]
    ref = group_loop(
        bgt, *(torch.as_tensor(x) for x in (y0, ug0, vg0)), DT, NT,
        case["cut_off"], RTOL, ATOL, MIN_STEP, GROUP,
        None if pin is None else pin[0], None if pin is None else pin[1],
        case["max_iters"])
    out = port_run(bgt, y0, ug0, vg0, case)
    for i in range(3):
        assert same(ref[i], out[i]), i
    assert [int(x) for x in ref[3]] == out[3].tolist()
    assert ref[4] == out[5]
    assert out[6].shape == (3, y0.shape[1])


@pytest.mark.parametrize("name", list(CASES))
def test_dense_run_matches_jax(batch, jax_spread, name):
    bgj, bgt, seeds, _ = batch
    scales, spread = jax_spread
    case = CASES[name]
    ref = jax_run(bgj, *seeds, case)
    out = [x.numpy() if torch.is_tensor(x) else x
           for x in port_run(bgt, *seeds, case)]
    for i, what in ((0, "rows"), (1, "ug"), (2, "vg")):
        np.testing.assert_array_equal(np.isnan(ref[i]), np.isnan(out[i]),
                                      err_msg=what)
    assert int(ref[5]) == out[5]
    d = per_lane_diff(ref, out, scales)
    if name == "maxiters":
        assert d.max() <= 1e-12, d.max()
        np.testing.assert_array_equal(np.asarray(ref[3]), out[3])
        assert out[5] > 0
        with pytest.raises(ttracer.MaxItersTruncation):
            ttracer._check_truncation(out[5])
        return
    assert out[5] == 0
    assert np.quantile(d, 0.85) <= 1e-9, np.sort(d)[-30:]
    assert d.max() <= 2 * spread.max(), (d.max(), spread.max())


def test_batch_covers_the_cases(batch):
    """Frozen rootless lanes keep their seed rows and get NaN (ug, vg);
    cut_off 0.03 kills lanes at bounds inside groups; the polar lanes stay
    alive in the cap; padded bounds are cut off."""
    _, bgt, (y0, ug0, vg0), _ = batch
    out = port_run(bgt, y0, ug0, vg0, CASES["pin"])
    ys, ugs = out[0].numpy(), out[1].numpy()
    assert ys.shape == (NT, 5, y0.shape[1]) and (NT - 1) % GROUP
    rootless = np.isnan(y0[3])
    assert rootless.sum() == 72
    assert same(ys[:, :, rootless], np.broadcast_to(y0[:, rootless],
                                                    ys[:, :, rootless].shape))
    assert np.isnan(ugs[1:, rootless]).all()
    # Lanes are (root, source, zwn) in C order; the last 3 of 23 sources
    # are the polar ones.
    polar = (np.arange(y0.shape[1]) // 3) % 23 >= 20
    alive = np.isfinite(ys[-1, 0]) & ~rootless
    assert (polar & ~rootless).sum() >= 6
    assert alive[polar & ~rootless].all()
    killed = port_run(bgt, y0, ug0, vg0, CASES["cutoff"])[0].numpy()
    dead = np.isnan(killed[:, 0]) & ~rootless
    first = dead.argmax(axis=0)[dead.any(axis=0)]
    mid_group = first[(first - 1) % GROUP != 0]
    assert mid_group.size >= 5, first
    # Once dead, dead to the end.
    assert (np.diff(dead.astype(int), axis=0) >= 0).all()


def test_lane_subset_equals_full_batch_bitwise(batch):
    _, bgt, (y0, ug0, vg0), _ = batch
    y0, ug0, vg0 = (torch.as_tensor(x) for x in (y0, ug0, vg0))
    h0 = ttracer.initial_step_sizes(bgt, y0, RTOL, ATOL)
    f0 = tray.RayRHS(bgt)(y0)
    bounds_g = ttracer.padded_bounds(DT, NT, GROUP, torch.float64, "cpu")

    def run(idx):
        return ttracer._dense_run(
            bgt, y0[:, idx].contiguous(), ug0[idx], vg0[idx], h0[idx],
            f0[:, idx].contiguous(), bounds_g, NT - 1, 0.03, RTOL, ATOL,
            MIN_STEP, pin_limit=500, pin_mwn=0.0)

    every = torch.arange(y0.shape[1])
    sub = torch.cat([every[1::3], every[-9:]])
    full, part = run(every), run(sub)
    for a, b in zip(full[:5], part[:5]):
        assert same(a[..., sub], b)
    for a, b in zip(full.carry, part.carry):
        assert same(a[..., sub], b)


def test_cpu_dense_run_has_no_kernel_launch(batch):
    _, bgt, (y0, ug0, vg0), _ = batch
    before = ttracer.LAUNCHES, trk.LAUNCHES, tray.LAUNCHES
    port_run(bgt, y0, ug0, vg0, CASES["maxiters"])
    assert (ttracer.LAUNCHES, trk.LAUNCHES, tray.LAUNCHES) == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kill_test_bound_holds(dtype):
    """The whole-run kernel skips the haversine where s (1 + s^2), widened
    by 0.1 %, is under cut_off (s = |dlat| + |dlon|; csrc/ray_rhs.cuh
    kill_mask). The plain haversine must then be under cut_off too: here it
    is at most the bound itself (both are 0 where the move rounds away), on
    moves from 1e-9 rad to the far side of the sphere, in both dtypes."""
    rng = np.random.default_rng(5)
    n = 200_000
    lat_b = rng.uniform(-1.57, 1.57, n)
    lon_b = rng.uniform(-1.0, 7.3, n)
    size = 10.0 ** rng.uniform(-9, 0.6, n)
    ang = rng.uniform(0, 2 * np.pi, n)
    lat_a = np.clip(lat_b + size * np.sin(ang), -1.57, 1.57)
    lon_a = lon_b + size * np.cos(ang) / np.maximum(np.cos(lat_b), 0.05)
    a, b, c, d = (torch.as_tensor(x, dtype=dtype)
                  for x in (lon_a, lat_a, lon_b, lat_b))
    ddis = tray.haversine(a, b, c, d)
    s = torch.abs(b - d) + torch.abs(a - c)
    bound = s * (1.0 + s * s) * 1.001
    assert (ddis <= bound).all()
    moved = bound > 0
    assert float((ddis[moved] / bound[moved]).max()) > 0.99 / 1.001
