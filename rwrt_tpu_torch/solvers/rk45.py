"""Adaptive Dormand-Prince 5(4) with per-ray step control, dense output.

Port of the dense path of ``rwrt_tpu/solvers/rk45.py``: the tableau and
controller constants, ``select_initial_step``, ``validate_tol``,
``dense_entry_state`` and ``integrate_group_dense`` with its straggler
pin-kill. The exact-mode integrators are not ported yet.

``integrate_group_dense`` is one of the port's hand-written kernels (the
single-group instance of ``csrc/dense_run.cu``): on a CUDA state it launches
one thread per lane, each looping to the group's last bound inside one
launch; on a CPU state it runs the plain PyTorch loop
``_integrate_group_dense_plain``, the JAX ``while_loop`` written out.
``LAUNCHES`` counts kernel launches. ``trace_rays`` does not call it: the
whole-run instance of the same kernel (``tracer._dense_run``) runs every
group in one launch.
"""

from __future__ import annotations

import math

import torch

from rwrt_tpu_torch import kernels
from rwrt_tpu_torch.models.ray import RayRHS
from rwrt_tpu_torch.ops.interp import true_div

# Dormand-Prince 5(4) tableau.
DP_C = (0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0)
DP_A = (
    (0.0, 0.0, 0.0, 0.0, 0.0),
    (1 / 5, 0.0, 0.0, 0.0, 0.0),
    (3 / 40, 9 / 40, 0.0, 0.0, 0.0),
    (44 / 45, -56 / 15, 32 / 9, 0.0, 0.0),
    (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729, 0.0),
    (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656),
)
DP_B = (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84)
DP_E = (
    -71 / 57600, 0.0, 71 / 16695, -71 / 1920, 17253 / 339200, -22 / 525,
    1 / 40,
)

SAFETY = 0.9
MIN_FACTOR = 0.2
MAX_FACTOR = 10.0
ERROR_EXPONENT = -0.2  # -1/(error_estimator_order + 1), order 4.

# Dense-output quartic: b_i(theta) = sum_j DP_P[i][j] * theta^(j+1).
DP_P = (
    (1.0, -8048581381 / 2820520608, 8663915743 / 2820520608,
     -12715105075 / 11282082432),
    (0.0, 0.0, 0.0, 0.0),
    (0.0, 131558114200 / 32700410799, -68118460800 / 10900136933,
     87487479700 / 32700410799),
    (0.0, -1754552775 / 470086768, 14199869525 / 1410260304,
     -10690763975 / 1880347072),
    (0.0, 127303824393 / 49829197408, -318862633887 / 49829197408,
     701980252875 / 199316789632),
    (0.0, -282668133 / 205662961, 2019193451 / 616988883,
     -1453857185 / 822651844),
    (0.0, 40617522 / 29380423, -110615467 / 29380423, 69997945 / 29380423),
)

#: Pin-off sentinel: a lane's attempt count never reaches it.
PIN_OFF = 2 ** 30

#: Number of dense-group kernel launches in this process.
LAUNCHES = 0


def as_scalar(x, dtype: torch.dtype) -> float:
    """``x`` rounded to ``dtype``, as a Python float (the form scalars take
    in the port, so plain versions and kernels see one value)."""
    return float(torch.tensor(float(x), dtype=torch.float64).to(dtype))


def _norm(x):
    """RMS norm over the variable axis: ||x||_2 / sqrt(n). The squares are
    summed in row order, as the dense-group kernel sums them."""
    sq = x[0] * x[0]
    for row in x[1:]:
        sq = sq + row * row
    return torch.sqrt(true_div(sq, x.shape[0]))


def validate_tol(rtol, dtype) -> float:
    """Clamp rtol to 100 * eps of the compute dtype (float32 gives about
    1.19e-5)."""
    return max(as_scalar(rtol, dtype), 100 * torch.finfo(dtype).eps)


def select_initial_step(rhs_fn, y0, f0, rtol, atol, t0=0.0):
    """Per-ray initial step (Hairer; direction +1). The smallness masks are
    ~(d > 1e-15), so NaN d counts as small; fmax has nanmax semantics."""
    scale = atol + torch.abs(y0) * rtol
    d0 = _norm(y0 / scale)
    d1 = _norm(f0 / scale)
    h0 = 0.01 * d0 / d1
    h0 = torch.where((d0 < 1e-5) | (d1 < 1e-5), torch.full_like(h0, 1e-6),
                     h0)

    y1 = y0 + h0 * f0
    f1 = rhs_fn(y1, t0 + h0)
    d2 = _norm((f1 - f0) / scale) / h0

    dm = torch.fmax(d1, d2)
    h1 = (0.01 / dm) ** (1.0 / 5.0)
    both_small = torch.logical_not(d1 > 1e-15) & torch.logical_not(d2 > 1e-15)
    h1 = torch.where(both_small, torch.clamp(h0 * 1e-3, min=1e-6), h1)
    return torch.minimum(100.0 * h0, h1)


def dense_entry_state(y, bounds):
    """NaN-entry prefill for the dense grouped integrator.

    Lanes with any NaN component ("frozen": rootless or already dead) keep
    their entry state at every bound and finish at once; live lanes' slots
    start NaN and are filled on emission. Returns (hist0 (G, 5, R),
    rejected0, new_step0, lane_att0, t_shift) with t_shift = bounds[-1] on
    frozen lanes and NaN elsewhere.
    """
    g = bounds.shape[0]
    nan_mean = torch.isnan(torch.mean(y, dim=0))
    t_shift = torch.where(nan_mean, bounds[-1],
                          torch.full_like(y[0], float("nan")))
    hist0 = torch.where(nan_mean[None, None, :],
                        y[None].expand(g, *y.shape),
                        torch.full((g, *y.shape), float("nan"),
                                   dtype=y.dtype, device=y.device))
    return (hist0, torch.zeros_like(nan_mean), torch.ones_like(nan_mean),
            torch.zeros(y.shape[1], dtype=torch.int32, device=y.device),
            t_shift)


def integrate_group_dense(
    rhs_fn, y, t, h, f, bounds, rtol, atol, min_step,
    max_iters=1_000_000, pin_limit=None, pin_mwn=None,
):
    """Free-stepping integration over a group of bounds with DENSE OUTPUT.

    Each lane steps freely (clamped only at the final bound) and the bounds a
    step spans are emitted from the Dormand-Prince quartic interpolant of
    that step. A NaN error norm rejects at MIN_FACTOR unless the state is
    already NaN or the step is at the floor. With ``pin_limit`` set, a lane
    whose attempt count reaches it while |ky| (row 3) >= pin_mwn is
    NaN-retired, on an accepted step or on a rejection at the step floor.

    Args:
      rhs_fn: (y, t) -> dy. On CUDA it must be a ``models.ray.RayRHS``.
      y, f: (5, R) state and its rhs (FSAL carry); t, h: (R,).
      bounds: (G,) non-decreasing output times (not checked: the check
        would cost a device-to-host read per group).
      rtol, atol, min_step: scalars.

    Returns (hist (G, 5, R), y, t, h, f, iters, nfev, lane_att, rejected,
    new_step); iters is the batch-wide trip count, max over lanes of
    lane_att (a device scalar on CUDA, so nothing waits for the card), and
    each lane stops at its own max_iters trips.
    """
    run = (_integrate_group_dense_cuda if y.is_cuda
           else _integrate_group_dense_plain)
    return run(rhs_fn, y, t, h, f, bounds, rtol, atol, min_step, max_iters,
               pin_limit, pin_mwn)


def _scalar_args(dtype, rtol, atol, min_step, pin_limit, pin_mwn):
    if (pin_limit is None) != (pin_mwn is None):
        raise ValueError("pin_limit and pin_mwn are set together")
    if pin_limit is None:
        pin_limit, pin_mwn = PIN_OFF, math.inf
    return (as_scalar(rtol, dtype), as_scalar(atol, dtype),
            as_scalar(min_step, dtype), int(pin_limit),
            as_scalar(pin_mwn, dtype))


def _integrate_group_dense_plain(
        rhs_fn, y, t, h, f, bounds, rtol, atol, min_step, max_iters,
        pin_limit=None, pin_mwn=None):
    """The plain PyTorch version: the batch-wide JAX loop written out."""
    rtol, atol, min_step, pin_limit, pin_mwn = _scalar_args(
        y.dtype, rtol, atol, min_step, pin_limit, pin_mwn)
    t_end = bounds[-1]
    hist, rejected, new_step, lane_att, t_shift = dense_entry_state(y, bounds)
    t = torch.where(torch.isnan(t_shift), t, t_shift)
    floor_thr = torch.tensor(min_step, dtype=y.dtype) * (1 + 1e-6)
    nan = torch.full_like(y, float("nan"))

    iters = 0
    while iters < max_iters and bool(torch.any(t < t_end)):
        act = t < t_end

        f0 = f
        heff = torch.where(new_step, torch.clamp(h, min=min_step), h)
        t_new = torch.minimum(t + heff, t_end)
        hstep = t_new - t

        k = [f0]
        for s in range(1, 6):
            dy = hstep[None, :] * sum(
                DP_A[s][j] * k[j] for j in range(s) if DP_A[s][j] != 0.0
            )
            k.append(rhs_fn(y + dy, t + DP_C[s] * hstep))
        y_new = y + hstep[None, :] * sum(DP_B[j] * k[j] for j in range(6))
        f_new = rhs_fn(y_new, t_new)
        k.append(f_new)

        err = hstep[None, :] * sum(DP_E[j] * k[j] for j in range(7))
        scale = atol + torch.maximum(torch.abs(y), torch.abs(y_new)) * rtol
        error_norm = _norm(err / scale)

        nan_err = torch.isnan(error_norm)
        dead_now = torch.isnan(y[0])
        at_floor = hstep <= min_step
        accept = torch.where(nan_err, dead_now | at_floor, error_norm < 1.0)
        raw = SAFETY * error_norm ** ERROR_EXPONENT
        fac_acc = torch.clamp(raw, max=MAX_FACTOR)
        fac_acc = torch.where(rejected, torch.clamp(fac_acc, max=1.0),
                              fac_acc)
        fac_acc = torch.where(nan_err, torch.ones_like(fac_acc), fac_acc)
        fac_rej = torch.clamp(raw, min=MIN_FACTOR)
        fac_rej = torch.where(nan_err, torch.full_like(fac_rej, MIN_FACTOR),
                              fac_rej)
        h_next = torch.where(accept, hstep * fac_acc, hstep * fac_rej)

        upd = act & accept

        # Dense emission: every bound spanned by this accepted step.
        crossed = (upd[None, :] & (bounds[:, None] > t[None, :])
                   & (bounds[:, None] <= t_new[None, :]))
        th = (bounds[:, None] - t[None, :]) / torch.where(
            hstep == 0, torch.ones_like(hstep), hstep)[None, :]
        bp = [th * (p0 + th * (p1 + th * (p2 + th * p3)))
              for (p0, p1, p2, p3) in DP_P]
        y_interp = y[None] + hstep[None, None, :] * sum(
            bp[i][:, None, :] * k[i][None] for i in range(7))
        hist = torch.where(crossed[:, None, :], y_interp, hist)

        t_out = torch.where(upd, t_new, t)
        y_out = torch.where(upd[None, :], y_new, y)

        # Straggler pin-kill on accepted steps and on floor rejections.
        lane_att_out = lane_att + act.to(torch.int32)
        floor_rej = act & ~accept & (hstep <= floor_thr)
        retire = ((upd | floor_rej) & (lane_att_out >= pin_limit)
                  & (torch.abs(y_out[3]) >= pin_mwn))
        y_out = torch.where(retire[None, :], nan, y_out)

        # Lanes whose state went NaN finish at once.
        t = torch.where(act & torch.isnan(y_out[0]), t_end, t_out)
        y = y_out
        f = torch.where(upd[None, :], f_new, f)
        h = torch.where(act, h_next, h)
        rejected = torch.where(act, ~accept, rejected)
        new_step = torch.where(act, accept, new_step)
        lane_att = lane_att_out
        iters += 1

    return (hist, y, t, h, f, iters, 6 * iters, lane_att, rejected,
            new_step)


def _integrate_group_dense_cuda(
        rhs_fn, y, t, h, f, bounds, rtol, atol, min_step, max_iters,
        pin_limit, pin_mwn):
    """Launch the dense-group kernel: one thread per lane, the whole group
    in one launch. The entry state is computed inside the kernel."""
    global LAUNCHES
    if not isinstance(rhs_fn, RayRHS):
        raise TypeError("on CUDA the dense-group kernel integrates the ray "
                        "RHS only: pass models.ray.RayRHS(bg)")
    bg = rhs_fn.bg
    dev, dt = y.device, y.dtype
    if y.ndim != 2 or y.shape[0] != 5:
        raise ValueError(f"y must be (5, R); got {tuple(y.shape)}")
    r = y.shape[1]
    g = bounds.shape[0]
    for name, x, shape in (("y", y, (5, r)), ("t", t, (r,)), ("h", h, (r,)),
                           ("f", f, (5, r)), ("bounds", bounds, (g,))):
        kernels.check_tensor(x, name, device=dev, dtype=dt, shape=shape)
    packed = bg.fields
    kernels.check_tensor(packed, "fields", device=dev, dtype=dt)
    kernels.check_aligned(packed, "fields")
    if packed.ndim != 3 or packed.shape[-1] != 48 or bg.member_ids is not None:
        raise ValueError("the dense-group kernel needs a static "
                         "corner-packed (W, H, 48) background")
    if g < 1:
        raise ValueError("bounds must be non-empty")
    rtol, atol, min_step, pin_limit, pin_mwn = _scalar_args(
        dt, rtol, atol, min_step, pin_limit, pin_mwn)

    y, t, h, f = (x.clone() for x in (y, t, h, f))  # updated in place
    hist = torch.empty((g, 5, r), dtype=dt, device=dev)
    rejected = torch.empty(r, dtype=torch.bool, device=dev)
    new_step = torch.empty(r, dtype=torch.bool, device=dev)
    lane_att = torch.empty(r, dtype=torch.int32, device=dev)
    w, hh, _ = packed.shape
    kernels.launch(
        "rwrt_dense_group", dt, packed, w, hh, bg.lon0, bg.lat0, bg.dx,
        bg.dy, y, t, h, f, rejected, new_step, lane_att, hist, bounds, g, r,
        rtol, atol, min_step, int(max_iters), pin_limit, pin_mwn,
        kernels.stream(dev))
    LAUNCHES += 1
    iters = lane_att.max() if r else 0
    return (hist, y, t, h, f, iters, 6 * iters, lane_att, rejected,
            new_step)
