"""The work arithmetic: the counts are chip_smoke.py's, and a tiny case's
bytes and operations equal a count by hand."""

import chip_smoke as cs
from portbench import work


def test_constants_are_chip_smokes():
    for name in ("RHS_FLOPS", "ATTEMPT_FLOPS", "ROW_FLOPS", "CASCADE_FLOPS",
                 "RK4_STEP_FLOPS", "TIME_SAMPLE_FLOPS", "HBM_BYTES_PER_S",
                 "MIX_ATTEMPT_FLOPS", "MIX_RK4_STEP_FLOPS"):
        assert getattr(work, name) == getattr(cs, name), name
    for unit, peak in work.PEAK_FLOPS.items():
        assert cs.PEAK_FLOPS[unit] == peak


def test_dense_bound_by_hand():
    # 2 lanes, 3 rows kept, 4 output rows, 2 groups of 2 bounds, 5
    # attempts, float32, a 1,000-byte stack, static.
    w = work.RunFacts("rk45", "dense", lanes=2, rows=3, nt=4, groups=2,
                      group=2, attempts=5, state_size=4, field_size=4,
                      stack_bytes=1000, timed=False, dtype="float32")
    b = work.dense_run_bound(w)
    # in: y0 40, ug0 8, vg0 8, h0 8, f0 40, bounds 16; out: ys+ugs+vgs
    # 4*7*2*4 = 224, lane_att 16, trunc 8, carry y 40 t 8 h 8 f 40 plon 8
    # plat 8.
    assert b.bytes == 1000 + 40 + 8 + 8 + 8 + 40 + 16 + 224 + 16 + 8 + (
        40 + 8 + 8 + 40 + 8 + 8)
    assert b.flops == 5 * (6 * 182 + 342) + 3 * (126 + 156)
    timed = work.dense_run_bound(w._replace(timed=True))
    assert timed.flops == b.flops + (6 * 5 + 3) * 123
    mixed = work.dense_run_bound(w._replace(state_size=8, dtype="float64"))
    assert mixed.flops == b.flops
    assert mixed.ms == max(5 * 1337 / 67e12 + (5 * 97 + 3 * 282) / 34e12,
                           mixed.bytes / 3.35e12) * 1e3
    t_ops = b.flops / 67e12
    t_bytes = b.bytes / 3.35e12
    assert abs(b.ms - max(t_ops, t_bytes) * 1e3) < 1e-18
    assert b.by == ("bytes" if t_bytes >= t_ops else "operations")


def test_rk4_bound_by_hand():
    w = work.RunFacts("rk4", "exact", lanes=3, rows=10, nt=5, groups=0,
                      group=0, attempts=0, state_size=8, field_size=8,
                      stack_bytes=500, timed=False, dtype="float64")
    b = work.rk4_bound(w)
    # y0 + ug0 + vg0 in, 5 rows of ys + ugs + vgs out: 7 * 3 * 8 * (1 + 5).
    assert b.bytes == 500 + 7 * 3 * 8 * 6
    assert b.flops == 10 * (4 * 182 + 65 + 156)
    assert work.rk4_bound(w._replace(timed=True)).flops == b.flops + 50 * 123
    assert b.ms == max(b.flops / 34e12, b.bytes / 3.35e12) * 1e3
    assert work.bounds(w) == {"rk4_run": b}
    assert work.bounds(w._replace(integrator="rk45")) == {}


def test_ray_steps():
    assert work.ray_steps(100_800, 361) == 36_288_000
    assert work.ray_steps(6_615, 1081) == 7_144_200
