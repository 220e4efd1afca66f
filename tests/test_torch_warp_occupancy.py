"""The whole-run dense kernel's warp occupancy, as ``profile_main_path.py``
computes it from a run's step attempts (``lane_att``).

``warp_occupancy``: the share of the lane-slots a launch issues that carry
a live lane, one thread running each lane to its end in launch order: lane
iterations (trips plus one per group opened, plus the last close) over 32
times the sum over warps of the warp's most. Held here to hand-made
``lane_att`` arrays with known answers and to a brute-force count on the
plain run's attempts over the ``jet_field`` background.
``repacked_occupancy``: the repacking kernel's schedule
(``csrc/dense_run.cu``), held to the closed forms of its limits: one warp
per block and windows longer than any lane give the launch-order value;
one block holding every lane and a repack at every iteration give the
least warp-iterations any schedule of these lanes can issue.
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
from rwrt_tpu_torch import tracer  # noqa: E402


def att(trips_per_lane, n_groups=1):
    """(n_groups, R) attempts whose sums over groups are the given trips
    (all in group 0)."""
    a = np.zeros((n_groups, len(trips_per_lane)), dtype=np.int32)
    a[0] = trips_per_lane
    return a


@pytest.mark.parametrize("n_groups", [1, 6])
@pytest.mark.parametrize("r", [32, 96, 512])
def test_equal_lanes_fill_every_warp(r, n_groups):
    assert pmp.warp_occupancy(att([113] * r, n_groups)) == 1.0


@pytest.mark.parametrize("straggler", [200, 910])
def test_one_straggler_per_warp(straggler):
    """31 lanes of 85 trips and one straggler a warp, over 6 groups: each
    warp issues the straggler's iterations for all 32 slots."""
    n_groups = 6
    trips = ([85] * 31 + [straggler]) * 4
    c = n_groups + 1
    want = (31 * (85 + c) + straggler + c) / (32 * (straggler + c))
    got = pmp.warp_occupancy(att(trips, n_groups))
    assert got == pytest.approx(want, rel=1e-15)


def test_ragged_last_warp_counts_its_full_width():
    assert pmp.warp_occupancy(att([40] * 33)) == pytest.approx(33 / 64)


def test_one_lane():
    assert pmp.warp_occupancy(att([910], 6)) == pytest.approx(1 / 32)


def test_iterations_add_group_changes():
    a = np.array([[3, 0], [5, 1]])
    assert pmp.lane_iterations(a).tolist() == [3 + 5 + 3, 0 + 1 + 3]
    assert pmp.lane_iterations(torch.as_tensor(a)).tolist() == [11, 4]


@pytest.fixture(scope="module")
def plain_lane_att(jet_field):
    """``_dense_run_plain``'s attempts on the jet background: the 207-lane
    batch of the dense-run tests (a 5 x 4 source grid, three polar
    sources, zwn 2, 4, 6), 12 bounds in groups of 5, pin (500, 0)."""
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
    out = tracer._dense_run_plain(bg, y0, ug0, vg0, h0, f0, bounds_g, 12,
                                  0.2, 1e-6, 1e-6, 7.2, pin_limit=500,
                                  pin_mwn=0.0)
    return out.lane_att


def test_plain_run_occupancy_is_the_brute_force_count(plain_lane_att):
    a = plain_lane_att.numpy()
    assert a.shape == (3, 207)
    it = [int(a[:, j].sum()) + a.shape[0] + 1 for j in range(a.shape[1])]
    issued = sum(max(it[w:w + 32]) for w in range(0, len(it), 32))
    want = sum(it) / (32 * issued)
    got = pmp.warp_occupancy(plain_lane_att)
    assert got == pytest.approx(want, rel=1e-15)
    assert 0.0 < got < 1.0


def test_one_warp_blocks_and_long_windows_keep_launch_order(plain_lane_att):
    """Blocks of one warp, lanes dealt 32 a block, one window longer than
    any lane: nothing is repacked, so the launch-order value."""
    a = plain_lane_att[:, :192]
    occ, issued = pmp.repacked_occupancy(a, 32, 6, 10 ** 6)
    assert occ == pytest.approx(pmp.warp_occupancy(a), rel=1e-15)
    assert issued.tolist() == [
        int(pmp.lane_iterations(a)[b * 32:(b + 1) * 32].max())
        for b in range(6)]


@pytest.mark.parametrize("block", [256, 512])
def test_repack_every_iteration_issues_the_fewest(plain_lane_att, block):
    """One block holding every lane, repacked at every iteration: at
    iteration t it issues ceil(lanes still running / 32) warps."""
    it = pmp.lane_iterations(plain_lane_att)
    least = sum(math.ceil(int((it >= t).sum()) / 32)
                for t in range(1, int(it.max()) + 1))
    occ, issued = pmp.repacked_occupancy(plain_lane_att, block, 1, 1)
    assert issued.tolist() == [least]
    assert occ == pytest.approx(int(it.sum()) / (32 * least), rel=1e-15)
    assert occ >= pmp.warp_occupancy(plain_lane_att)


def test_a_trigger_of_one_repacks_at_each_leave(plain_lane_att):
    """Windows ended as soon as one lane leaves keep every warp full, as a
    repack at every iteration does."""
    it = pmp.lane_iterations(plain_lane_att)
    least = sum(math.ceil(int((it >= t).sum()) / 32)
                for t in range(1, int(it.max()) + 1))
    occ, issued = pmp.repacked_occupancy(plain_lane_att, 256, 1, 10 ** 6, 1)
    assert issued.tolist() == [least]
    wide, _ = pmp.repacked_occupancy(plain_lane_att, 256, 1, 10 ** 6, 32)
    assert occ >= wide >= pmp.warp_occupancy(plain_lane_att)


@pytest.mark.parametrize("every", [1, 4, 8])
def test_queue_refills_and_accounts_every_iteration(plain_lane_att, every):
    """More lanes than the grid's threads (2 blocks of 32 over 207 lanes):
    the queue refills freed threads; the issued warp-iterations cover
    every lane iteration, and the longer the window, the more they are."""
    it = pmp.lane_iterations(plain_lane_att)
    occ, issued = pmp.repacked_occupancy(plain_lane_att, 32, 2, every)
    assert issued.size == 2
    assert 32 * issued.sum() >= it.sum()
    assert 0.0 < occ <= 1.0
    if every > 1:
        finer, _ = pmp.repacked_occupancy(plain_lane_att, 32, 2, 1)
        assert finer >= occ
