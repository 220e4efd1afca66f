"""The whole-run exact kernel's repack schedule and its occupancy model, on
the CPU.

``tracer.EXACT_SCHEDULE`` must name a schedule (or launch order, None) for
every (state, field) dtype pair that ``kernels.state_key`` admits, and the
float64-state pairs, which repack, must have a team window
(``kernels.REPACKED_TEAM_LANES``) that ``rk45.exact_instance`` follows
with no resident cap.

``profile_main_path.warp_occupancy`` and ``repacked_occupancy`` read an
exact run's ``lane_att`` as a dense run's: a lane's loop iterations are its
trips over all groups plus one to open each group and one to close the
last (a NaN-amp lane's walk trips are not attempts and are not counted).
A team instance holds 32 / 8 = 4 lanes a warp and block / 8 lanes a block.
Held here to hand-made arrays and to a brute-force count on the plain exact
run (``tracer._exact_run_plain``) over the ``jet_field`` background.
"""

import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import profile_main_path as pmp  # noqa: E402
import rwrt_tpu_torch as pt  # noqa: E402
from rwrt_tpu_torch import kernels, tracer  # noqa: E402
from rwrt_tpu_torch.solvers import rk45  # noqa: E402

#: Lanes a warp: one thread a lane, or a team of 8 threads a lane.
WARPS = {"lane": 32, "split8": 4}


def test_schedule_covers_every_admitted_key():
    """Every (state, field) pair the kernels admit has an entry; float32
    keeps launch order, the float64-state pairs repack with positive
    windows and have a team window."""
    admitted = set(kernels._SUFFIX)
    assert set(tracer.EXACT_SCHEDULE) == admitted
    for key in admitted:
        y = torch.zeros((5, 1), dtype=key[0])
        fields = torch.zeros((1, 1, 48), dtype=key[1])
        assert kernels.state_key(y, fields) == key
        sched = tracer.EXACT_SCHEDULE[key]
        if key[0] == torch.float32:
            assert sched is None
            assert key not in kernels.REPACKED_TEAM_LANES
        else:
            every, trigger = sched
            assert every >= 1 and (trigger is None or trigger >= 1)
            lo, hi = kernels.REPACKED_TEAM_LANES[key]
            assert 1 <= lo <= hi


def test_dense_schedule_covers_the_same_keys():
    assert set(tracer.DENSE_SCHEDULE) == set(tracer.EXACT_SCHEDULE)


@pytest.mark.parametrize("key", list(kernels.REPACKED_TEAM_LANES),
                         ids=["mixed", "float64"])
def test_repacked_run_takes_its_window_without_a_cap(key):
    """The float64-state whole run: the team exactly on its window, at any
    lane count the window holds, however few lanes a wave holds (no card
    is asked: the run queues its lanes)."""
    lo, hi = kernels.REPACKED_TEAM_LANES[key]
    rs = np.unique(np.concatenate([np.geomspace(1, 10 ** 6, 200).astype(int),
                                   [lo - 1, lo, lo + 1, hi - 1, hi,
                                    hi + 1]]))
    got = [rk45.exact_instance(int(r), key) for r in rs]
    assert got == [kernels.TEAM if lo <= r <= hi else "lane" for r in rs]


def att(trips_per_lane, n_groups=1):
    """(n_groups, R) attempts whose sums over groups are the given trips
    (all in group 0)."""
    a = np.zeros((n_groups, len(trips_per_lane)), dtype=np.int32)
    a[0] = trips_per_lane
    return a


@pytest.mark.parametrize("instance", list(WARPS))
def test_one_straggler_per_warp(instance):
    """Lanes of 40 trips and one straggler of 400 a warp, over 3 groups:
    each warp issues the straggler's iterations for all its slots."""
    w = WARPS[instance]
    c = 3 + 1
    trips = ([40] * (w - 1) + [400]) * 5
    want = ((w - 1) * (40 + c) + 400 + c) / (w * (400 + c))
    got = pmp.warp_occupancy(att(trips, 3), w)
    assert got == pytest.approx(want, rel=1e-15)


def test_team_warps_hold_four_lanes():
    """Four lanes a warp: the first warp (10, 10, 10, 50 trips) issues its
    straggler's iterations four times, the second (10 x 4) is full; one
    warp of 32 would issue the straggler's for all eight."""
    trips = [10, 10, 10, 50, 10, 10, 10, 10]
    it = [t + 2 for t in trips]
    want = sum(it) / (4 * (max(it[:4]) + max(it[4:])))
    assert pmp.warp_occupancy(att(trips), 4) == pytest.approx(want,
                                                             rel=1e-15)
    assert pmp.warp_occupancy(att(trips), 32) == pytest.approx(
        sum(it) / (32 * max(it)), rel=1e-15)


def test_ragged_team_warp_counts_its_full_width():
    assert pmp.warp_occupancy(att([40] * 5), 4) == pytest.approx(5 / 8)


@pytest.fixture(scope="module")
def exact_lane_att(jet_field):
    """``_exact_run_plain``'s attempts on the jet background: the 207-lane
    batch of the dense-run tests (a 5 x 4 source grid, three polar
    sources, zwn 2, 4, 6), 12 bounds in groups of 5, cut_off 0.03 (so
    lanes die inside groups and skip their remaining bounds)."""
    u, v, lat, lon = jet_field
    bs = pt.prepare(u, v, lat, lon, cal_dtype="float64", device="cpu")
    bg = tracer.make_background(bs, 0.0)
    slon, slat = tracer.source_matrix(0.0, 5.0, 36.0, 8.0, 5, 4)
    slon = np.concatenate([slon, np.radians([10.0, 100.0, 200.0])])
    slat = np.concatenate([slat, np.radians([86.0, 88.5, -87.0])])
    y0, ug0, vg0 = tracer.initialize(
        bg, torch.as_tensor(slon), torch.as_tensor(slat),
        torch.tensor([2.0, 4.0, 6.0], dtype=torch.float64))
    y0 = y0.contiguous()
    h0 = tracer.initial_step_sizes(bg, y0, 1e-6, 1e-6)
    f0 = tracer.ray_mod.RayRHS(bg)(y0)
    bounds_g = tracer.padded_bounds(7200.0, 13, 5, torch.float64, "cpu")
    out = tracer._exact_run_plain(bg, y0, ug0, vg0, h0, f0, bounds_g, 12,
                                  0.03, 1e-6, 1e-6, 7.2)
    return out.lane_att


@pytest.mark.parametrize("instance", list(WARPS))
def test_plain_exact_run_occupancy_is_the_brute_force_count(exact_lane_att,
                                                            instance):
    a = exact_lane_att.numpy()
    assert a.shape == (3, 207)
    w = WARPS[instance]
    it = [int(a[:, j].sum()) + a.shape[0] + 1 for j in range(a.shape[1])]
    issued = sum(max(it[k:k + w]) for k in range(0, len(it), w))
    want = sum(it) / (w * issued)
    got = pmp.warp_occupancy(exact_lane_att, w)
    assert got == pytest.approx(want, rel=1e-15)
    assert 0.0 < got < 1.0
    # The lanes differ: some die early, rootless ones never step.
    trips = a.sum(axis=0)
    assert trips.min() < trips.max()


def test_team_occupancy_is_at_least_the_lanes(exact_lane_att):
    """Four lanes a warp pay less for a straggler than 32."""
    assert pmp.warp_occupancy(exact_lane_att, 4) >= pmp.warp_occupancy(
        exact_lane_att, 32)


@pytest.mark.parametrize("instance", list(WARPS))
def test_repack_every_iteration_issues_the_fewest(exact_lane_att, instance):
    """One block of 256 threads holding every lane (256 / 8 slots for a
    team), repacked at every iteration: at iteration t it issues
    ceil(lanes still running / lanes a warp) warps, while the slots hold
    them all."""
    w = WARPS[instance]
    slots = 256 // (32 // w)
    a = exact_lane_att[:, :slots]
    it = pmp.lane_iterations(a)
    least = sum(math.ceil(int((it >= t).sum()) / w)
                for t in range(1, int(it.max()) + 1))
    occ, issued = pmp.repacked_occupancy(a, slots, 1, 1, None, w)
    assert issued.tolist() == [least]
    assert occ == pytest.approx(int(it.sum()) / (w * least), rel=1e-15)
    assert occ >= pmp.warp_occupancy(a, w)


@pytest.mark.parametrize("instance", list(WARPS))
def test_trigger_one_matches_every_iteration(exact_lane_att, instance):
    """The float64-state schedule's trigger of 1 (a repack as each lane
    leaves) keeps every warp full, as a repack at every iteration does."""
    w = WARPS[instance]
    slots = 256 // (32 // w)
    a = exact_lane_att[:, :slots]
    every, trigger = tracer.EXACT_SCHEDULE[(torch.float64, torch.float64)]
    occ, issued = pmp.repacked_occupancy(a, slots, 1, every, trigger, w)
    least, _ = pmp.repacked_occupancy(a, slots, 1, 1, None, w)
    assert occ == pytest.approx(least, rel=1e-15)


@pytest.mark.parametrize("every", [1, 4, 1 << 30])
def test_team_queue_refills_and_accounts_every_iteration(exact_lane_att,
                                                         every):
    """More lanes than the grid's slots (2 blocks of 8 team slots over 207
    lanes): the issued warp-iterations cover every lane iteration, and a
    longer window issues more."""
    it = pmp.lane_iterations(exact_lane_att)
    occ, issued = pmp.repacked_occupancy(exact_lane_att, 8, 2, every, None,
                                         4)
    assert issued.size == 2
    assert 4 * issued.sum() >= it.sum()
    assert 0.0 < occ <= 1.0
    if every > 1:
        finer, _ = pmp.repacked_occupancy(exact_lane_att, 8, 2, 1, None, 4)
        assert finer >= occ
