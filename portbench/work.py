"""The work a request needs, and the least time the card could take for it.

Operations are counted from the port's kernel sources (an add, multiply,
divide, sqrt or transcendental each) and bytes from the shapes of what a
whole-run kernel reads and writes, each once; the least time is the larger
of the operations over the card's published peak and the bytes over its
memory rate (NVIDIA's H100 SXM data sheet, at the full 700 W). The counts
depend on the request's data (step attempts, the rows the rays live to
write), so the caller gives what the run did: ``RunFacts``.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

#: H100 SXM data sheet: HBM bandwidth, the peaks outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}
#: One ray_rhs evaluation (csrc/ray_rhs.cuh: 119 for the sample, of which
#: 84 blend the 12 fields; 19 group velocity; 44 tendencies and outputs); a
#: step attempt of csrc/dense_run.cu beyond its six evaluations (175 stage
#: sums, 65 the 5th-order sum, 95 the error terms, 7 norm and controller);
#: an emitted bound (126 the quartic interpolant); its kill test and (ug,
#: vg) sample (18 + 138).
RHS_FLOPS = 182
ATTEMPT_FLOPS = 6 * RHS_FLOPS + 342
ROW_FLOPS = 126
CASCADE_FLOPS = 156
#: csrc/rk4_run.cu, a step: four evaluations, 65 for the stage inputs and
#: the update, the kill test and (ug, vg) sample.
RK4_STEP_FLOPS = 4 * RHS_FLOPS + 65 + CASCADE_FLOPS
#: What a sample of a time-varying stack adds to a static one
#: (csrc/ray_rhs.cuh lerp_frames): the second frame's row lerped (84), the
#: time blend of the 12 fields (36) and the frame fraction (3).
TIME_SAMPLE_FLOPS = 84 + 36 + 3
#: Mixed precision (a float64 state over float32 fields): the same counts
#: split by the units that do them. A step attempt: the six evaluations and
#: the stage, 5th-order and error sums in float32; the step products, the
#: adds into y, the error's scaling, the norm and the controller in
#: float64. A kept row's interpolant, kill test and (ug, vg) sample:
#: float64. An RK4 step: the evaluations and the stage sum in float32; the
#: stage inputs, the update, the kill test and (ug, vg) in float64.
MIX_ATTEMPT_FLOPS = {"float32": 6 * RHS_FLOPS + 245, "float64": 97}
MIX_RK4_STEP_FLOPS = {"float32": 4 * RHS_FLOPS + 25,
                      "float64": 40 + CASCADE_FLOPS}


class Bound(NamedTuple):
    """The least time of a kernel's work: ``ms``, and whether the
    ``operations`` or the ``bytes`` bound it."""

    ms: float
    by: str
    flops: float
    bytes: float


def bound(nbytes: float, flops: Dict[str, float]) -> Bound:
    """The larger of bytes over the memory rate and, summed over the
    units, flops over each unit's peak (``flops`` {unit: count})."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = sum(n / PEAK_FLOPS[u] for u, n in flops.items())
    return Bound(max(t_bytes, t_ops) * 1e3,
                 "bytes" if t_bytes >= t_ops else "operations",
                 float(sum(flops.values())), float(nbytes))


class RunFacts(NamedTuple):
    """What one request's whole run did: its ``integrator`` and
    ``bound_mode``, ``lanes`` the integrated lanes, ``rows`` the output
    rows past row 0 they kept (finite: in an RK4 run, the steps of the
    lanes alive after them), nt rows, ``groups`` x ``group`` output bounds
    and the step ``attempts`` (RK45), the state's and the fields' item
    sizes, the corner-packed stack's bytes, whether its sample blends two
    frames (``timed``) and the state's dtype name."""

    integrator: str
    bound_mode: str
    lanes: int
    rows: int
    nt: int
    groups: int
    group: int
    attempts: int
    state_size: int
    field_size: int
    stack_bytes: int
    timed: bool
    dtype: str


def dense_run_bound(w: RunFacts) -> Bound:
    """Bytes: the entry state (y0, ug0, vg0, h0 in the state's type, f0 in
    the fields'), the bounds and the stack in; the rows (ys, ugs, vgs), the
    attempts, the truncation count and the carry (y, t, h, f, plon, plat)
    out. Flops: each attempt's, and each kept row's interpolant, kill test
    and (ug, vg) sample; a timed stack's blend on each of an attempt's six
    samples and each row's."""
    r, s, f = w.lanes, w.state_size, w.field_size
    nbytes = (w.stack_bytes
              + r * (5 + 1 + 1 + 1) * s + 5 * r * f
              + w.groups * w.group * s
              + w.nt * 7 * r * s
              + w.groups * r * 4 + r * 4
              + r * (5 + 1 + 1 + 1 + 1) * s + 5 * r * f)
    if w.state_size > w.field_size:
        flops = {u: w.attempts * n for u, n in MIX_ATTEMPT_FLOPS.items()}
        flops["float64"] += w.rows * (ROW_FLOPS + CASCADE_FLOPS)
    else:
        flops = {w.dtype: w.attempts * ATTEMPT_FLOPS
                 + w.rows * (ROW_FLOPS + CASCADE_FLOPS)}
    if w.timed:
        field = "float64" if w.field_size == 8 else "float32"
        flops[field] = (flops.get(field, 0)
                        + (6 * w.attempts + w.rows) * TIME_SAMPLE_FLOPS)
    return bound(nbytes, flops)


def rk4_bound(w: RunFacts) -> Bound:
    """Bytes: the entry state and the stack in, the rows out; flops: the
    steps of the lanes alive after them (a dead lane's arithmetic is not
    needed), a timed stack's blend on each step's five samples."""
    nbytes = w.stack_bytes + w.lanes * 7 * w.state_size * (1 + w.nt)
    if w.state_size > w.field_size:
        flops = {u: w.rows * n for u, n in MIX_RK4_STEP_FLOPS.items()}
    else:
        flops = {w.dtype: w.rows * RK4_STEP_FLOPS}
    if w.timed:
        field = "float64" if w.field_size == 8 else "float32"
        flops[field] = flops.get(field, 0) + 5 * w.rows * TIME_SAMPLE_FLOPS
    return bound(nbytes, flops)


def bounds(w: RunFacts) -> Dict[str, Bound]:
    """The least times of the request's whole-run kernel, by the name its
    roofline reader asks for: "rk4_run" or "dense_run" (none yet for the
    exact-bound run)."""
    if w.integrator == "rk4":
        return {"rk4_run": rk4_bound(w)}
    if w.bound_mode == "dense":
        return {"dense_run": dense_run_bound(w)}
    return {}


def ray_steps(lanes: int, nt: int) -> int:
    """The ray-steps of a request: every ray slot advanced through every
    output interval (rootless and dead slots counted)."""
    return lanes * (nt - 1)


def compact_lane_indices(born):
    """The lanes a run integrates, as the port compacts them: the born ones
    (a root at the seed) padded with rootless ones to a multiple of 8; all
    lanes (None) where fewer than 8 would be saved."""
    import numpy as np

    born = np.asarray(born)
    n_rootless = int((~born).sum())
    if n_rootless < 8 or not born.any():
        return None
    idx = np.where(born)[0]
    pad = (-idx.size) % 8
    if pad:
        idx = np.concatenate([idx, np.where(~born)[0][:pad]])
    return idx
