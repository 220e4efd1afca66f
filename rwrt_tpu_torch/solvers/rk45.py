"""Adaptive Dormand-Prince 5(4) with per-ray step control.

Port of ``rwrt_tpu/solvers/rk45.py``: the tableau and controller constants,
``select_initial_step``, ``validate_tol``; the exact-bound integrators
(``integrate_interval``, the per-interval barrier path, and
``integrate_group`` with its entry state ``group_entry_state`` and its
suspend/resume ``state0``); the dense-output integrator
(``dense_entry_state``, ``integrate_group_dense`` with its straggler
pin-kill).

Two of these are hand-written kernels, each the single-group instance of a
whole-run kernel: ``integrate_group_dense`` (``csrc/dense_run.cu``) and
``integrate_group`` (``csrc/exact_run.cu``). On a CUDA state each launches
one thread (the exact kernel: or a team of 8 threads, ``exact_instance``)
per lane, looping through the group inside one launch; on a CPU
state each runs its plain PyTorch loop (``_integrate_group_dense_plain``,
``_integrate_group_plain``), the JAX ``while_loop`` written out.
``LAUNCHES`` and ``EXACT_LAUNCHES`` count their launches. ``trace_rays``
calls neither: the whole-run instances (``tracer._dense_run``,
``tracer._exact_run``) run every group in one launch. A third,
``integrate_interval_rays`` (``csrc/interval.cu``, counted by
``INTERVAL_LAUNCHES``), runs ``integrate_interval`` over the ray RHS with
a bound per lane in one launch: the re-run of
``termination.cause_labels``.

Mixed precision (a float64 state over a float32 background, the JAX
package's ``state_dtype='float64'``): the RHS rounds the state to the
background's dtype at entry, so the stages k and the FSAL carry f are
float32, and every expression here promotes as JAX's does: a stage sum
``sum(a_j k_j)`` is taken in float32 and multiplied by the float64 step,
the error estimate, the norm, the controller and the dense interpolant's
weights run in float64. The scalars (rtol, atol, min_step, cut_off,
pin_mwn) are rounded to the state's dtype. The plain versions serve it
on every device, and on the card the kernels' mixed instances.

Over a time-varying or ensemble background (``ray.kernel_background``'s
"_time" variant) both single-group kernels launch their time instances,
as the whole runs do.
"""

from __future__ import annotations

import math

import torch

from rwrt_tpu_torch import kernels
from rwrt_tpu_torch.models import ray as ray_mod
from rwrt_tpu_torch.models.ray import RayRHS
from rwrt_tpu_torch.ops.interp import lane_op, true_div

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
#: Number of exact-group kernel launches (``integrate_group`` on CUDA).
EXACT_LAUNCHES = 0
#: Number of interval kernel launches (``integrate_interval_rays`` on
#: CUDA).
INTERVAL_LAUNCHES = 0

def exact_instance(r: int, dtype, run: bool = True,
                   variant: str = "") -> str:
    """The exact kernel's instance for a launch of ``r`` lanes on the card:
    the whole run (``run``, ``tracer._exact_run``) or the single group
    (``integrate_group``). ``dtype`` is a torch dtype or a (state, field)
    pair (``kernels.launch``); ``variant`` "" (a static background) or
    "_time" (the time instance, ``ray.kernel_background``). The whole run
    with a float64 state queues its lanes on a persistent grid
    (``tracer.exact_grid``) and takes its own window,
    ``kernels.REPACKED_TEAM_LANES``."""
    key = kernels.dtype_key(dtype)
    if run and key in kernels.REPACKED_TEAM_LANES:
        return kernels.choose_instance(
            r, None, kernels.REPACKED_TEAM_LANES[key])
    return kernels.choose_instance(
        r, kernels.resident("exact", kernels.TEAM, dtype, int(run),
                            variant=variant))


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
    """Clamp rtol to 100 * eps of the state's dtype (float32 gives about
    1.19e-5; a float64 state over float32 fields keeps 1e-6)."""
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
    h1 = lane_op(torch.pow, 0.01 / dm, 1.0 / 5.0)
    both_small = torch.logical_not(d1 > 1e-15) & torch.logical_not(d2 > 1e-15)
    h1 = torch.where(both_small, torch.clamp(h0 * 1e-3, min=1e-6), h1)
    return torch.minimum(100.0 * h0, h1)


def _dp_trial(rhs_fn, y, t, hstep, f0):
    """Stages 2-6 of a Dormand-Prince trial step from the FSAL stage ``f0``:
    returns (the stage list k[0..5], the 5th-order proposal y_new)."""
    k = [f0]
    for s in range(1, 6):
        dy = hstep[None, :] * sum(
            DP_A[s][j] * k[j] for j in range(s) if DP_A[s][j] != 0.0
        )
        k.append(rhs_fn(y + dy, t + DP_C[s] * hstep))
    return k, y + hstep[None, :] * sum(DP_B[j] * k[j] for j in range(6))


def _error_norm(k, hstep, y, y_new, rtol, atol):
    """The scaled RMS norm of the embedded error estimate."""
    err = hstep[None, :] * sum(DP_E[j] * k[j] for j in range(7))
    scale = atol + torch.maximum(torch.abs(y), torch.abs(y_new)) * rtol
    return _norm(err / scale)


def _exact_error_norm(k, hstep, y, y_new, rtol, atol):
    """The exact integrators' error norm: a NaN norm counts as 0 (accept),
    as the reference's solver does."""
    error_norm = _error_norm(k, hstep, y, y_new, rtol, atol)
    return torch.where(torch.isnan(error_norm), torch.zeros_like(error_norm),
                       error_norm)


def _exact_factors(error_norm, rejected):
    """(fac_acc, fac_rej) of the exact integrators' step controller."""
    raw = SAFETY * lane_op(torch.pow, error_norm,
                           ERROR_EXPONENT)  # error 0 -> inf
    fac_acc = torch.clamp(raw, max=MAX_FACTOR)
    fac_acc = torch.where(rejected, torch.clamp(fac_acc, max=1.0), fac_acc)
    return fac_acc, torch.clamp(raw, min=MIN_FACTOR)


def integrate_interval(rhs_fn, y, t, h, t_bound, rtol, atol, min_step,
                       max_iters: int = 100_000):
    """Advance every ray from its own t to t_bound with adaptive stepping
    (the barrier path; plain PyTorch on every device).

    Lanes with a NaN component, or already at t_bound, are done at entry
    (NaN lanes jump to t_bound). The FSAL stage is evaluated at entry.

    Returns (y, t, h, iters, nfev, lane_att): iters the batch-wide attempt
    count, nfev = 6 * iters, and lane_att (R,) int32 each lane's attempts
    (an addition to the JAX return, for ``trace_rays``' stats).
    """
    rtol, atol, min_step = (as_scalar(x, y.dtype)
                            for x in (rtol, atol, min_step))
    tb = torch.as_tensor(t_bound, dtype=y.dtype,
                         device=y.device).expand_as(t)
    nan_mean = torch.isnan(torch.mean(y, dim=0))
    t = torch.where(nan_mean, tb, t)
    done = nan_mean | (t >= tb)
    f = rhs_fn(y, t)
    rejected = torch.zeros_like(done)
    new_step = torch.ones_like(done)
    lane_att = torch.zeros(y.shape[1], dtype=torch.int32, device=y.device)

    iters = 0
    while iters < max_iters and bool(torch.any(~done)):
        heff = torch.where(new_step, torch.clamp(h, min=min_step), h)
        t_new = t + heff
        t_new = torch.where(t_new > tb, tb, t_new)
        hstep = t_new - t

        k, y_new = _dp_trial(rhs_fn, y, t, hstep, f)
        f_new = rhs_fn(y_new, t_new)
        k.append(f_new)
        error_norm = _exact_error_norm(k, hstep, y, y_new, rtol, atol)

        accept = error_norm < 1.0
        fac_acc, fac_rej = _exact_factors(error_norm, rejected)
        h_next = torch.where(accept, hstep * fac_acc, hstep * fac_rej)

        act = ~done
        upd = act & accept
        y = torch.where(upd[None, :], y_new, y)
        f = torch.where(upd[None, :], f_new, f)
        t_out = torch.where(upd, t_new, t)
        t = torch.where(torch.isnan(t_out), tb, t_out)
        h = torch.where(act, h_next, h)
        rejected = torch.where(act, ~accept, rejected)
        new_step = torch.where(act, accept, new_step)
        done = done | (upd & (t >= tb))
        lane_att = lane_att + act.to(torch.int32)
        iters += 1
    return y, t, h, iters, 6 * iters, lane_att


def interval_instance(r: int, dtype, variant: str = "") -> str:
    """The interval kernel's instance for a launch of ``r`` lanes, chosen
    as ``exact_instance`` chooses the exact kernels'."""
    return kernels.choose_instance(
        r, kernels.resident("interval", kernels.TEAM, dtype,
                            variant=variant))


def integrate_interval_rays(bg, y, t, h, t_bound, rtol, atol, min_step,
                            max_iters: int = 100_000):
    """``integrate_interval`` over the ray RHS of background ``bg``, each
    lane from its own t to its own bound (``t_bound`` a scalar or (R,)).

    On a CUDA state one launch of the interval kernel
    (``csrc/interval.cu``): each lane's loop in registers, capped at
    ``max_iters`` of its own trips, which is the plain loop's batch-wide
    cap (a lane is active on every trip until it is done). On a CPU state
    the plain loop (``_integrate_interval_plain``). Returns
    ``integrate_interval``'s (y, t, h, iters, nfev, lane_att); on CUDA
    iters is a device scalar, the most trips of a lane.
    """
    run = (_integrate_interval_cuda if y.is_cuda
           else _integrate_interval_plain)
    return run(bg, y, t, h, t_bound, rtol, atol, min_step, max_iters)


def _integrate_interval_plain(bg, y, t, h, t_bound, rtol, atol, min_step,
                              max_iters: int = 100_000):
    """The plain version, on any device: ``integrate_interval`` over the
    plain RHS ``ray._rhs_core``."""
    def rhs_fn(yy, tt=0.0):
        return ray_mod._rhs_core(bg, yy, tt, False)[0]

    return integrate_interval(rhs_fn, y, t, h, t_bound, rtol, atol, min_step,
                              max_iters=max_iters)


def _integrate_interval_cuda(bg, y, t, h, t_bound, rtol, atol, min_step,
                             max_iters: int = 100_000, instance=None):
    """Launch the interval kernel: every lane's whole interval in one
    launch, one thread (or a team of threads) per lane as
    ``interval_instance`` chooses, or as ``instance`` says. The state
    takes the background's dtype (the kernel has no mixed instance)."""
    global INTERVAL_LAUNCHES
    key = kernels.state_key(y, bg.fields)
    if key[0] != key[1]:
        raise ValueError("the interval kernel takes a state of the "
                         f"background's dtype, not {y.dtype} over "
                         f"{bg.fields.dtype}")
    dev, dt = y.device, y.dtype
    if y.ndim != 2 or y.shape[0] != 5:
        raise ValueError(f"y must be (5, R); got {tuple(y.shape)}")
    r = y.shape[1]
    for name, x, shape in (("y", y, (5, r)), ("t", t, (r,)),
                           ("h", h, (r,))):
        kernels.check_tensor(x, name, device=dev, dtype=dt, shape=shape)
    tb = torch.as_tensor(t_bound, dtype=dt, device=dev).expand(r).contiguous()
    variant, bg_args = ray_mod.kernel_background(bg, dev, dt, r)
    rtol, atol, min_step = (as_scalar(x, dt) for x in (rtol, atol, min_step))
    y, t, h = (x.clone() for x in (y, t, h))  # updated in place
    lane_att = torch.empty(r, dtype=torch.int32, device=dev)
    kernels.launch(
        f"rwrt_interval{variant}", dt, *bg_args, y, t, h, tb, lane_att, r,
        rtol, atol, min_step, int(max_iters), kernels.instance_id(
            instance or interval_instance(r, dt, variant)),
        kernels.stream(dev))
    INTERVAL_LAUNCHES += 1
    iters = lane_att.max() if r else 0
    return y, t, h, iters, 6 * iters, lane_att


def group_entry_state(y, bounds):
    """NaN-entry prefill for the exact grouped integrator.

    Lanes whose DYNAMICS rows (lon, lat, kx, ky) hold a NaN (rootless or
    dead lanes) save their unchanged state at every bound with NaN (ug, vg)
    and finish at entry. A lane with a NaN amp and finite dynamics is not
    finished here: ``integrate_group`` walks it one bound per trip.

    Returns (hist0 (G, 7, R), rejected0, new_step0, lane_att0, idx0,
    t_shift) with t_shift = bounds[-1] on finished lanes and NaN elsewhere;
    apply as ``t = where(isnan(t_shift), t, t_shift)``.
    """
    g = bounds.shape[0]
    r = y.shape[1]
    nan_dyn = torch.isnan(torch.mean(y[:4], dim=0))
    idx0 = nan_dyn.to(torch.int32) * g
    t_shift = torch.where(nan_dyn, bounds[-1],
                          torch.full_like(y[0], float("nan")))
    filled = torch.cat([y[None].expand(g, *y.shape),
                        torch.full((g, 2, r), float("nan"), dtype=y.dtype,
                                   device=y.device)], dim=1)
    hist0 = torch.where(nan_dyn[None, None, :], filled,
                        torch.full_like(filled, float("nan")))
    return (hist0, torch.zeros_like(nan_dyn), torch.ones_like(nan_dyn),
            torch.zeros(r, dtype=torch.int32, device=y.device), idx0,
            t_shift)


def integrate_group(
    rhs_fn, rhs_gv_fn, y, t, h, f, bounds, prev_lon, prev_lat, cut_off,
    rtol, atol, min_step, max_iters=1_000_000, state0=None,
):
    """Advance every ray through a GROUP of output bounds, each ray on its
    own: numerically identical to ``integrate_interval`` once per bound
    with the tracer's kill test between intervals.

    Each ray clamps its step at every bound, applies the kill test at each
    crossing against its own last saved position, NaNs the saved row (state
    and (ug, vg)) of a killed crossing and skips its remaining bounds. The
    (ug, vg) saved at a crossing come from the 7th stage's sample of the
    saved state (``rhs_gv_fn``). A lane with a NaN amp and finite dynamics
    is walked one bound per trip, its state unchanged, its attempts not
    counted.

    Args:
      rhs_fn: (y, t) -> dy; on CUDA a ``models.ray.RayRHS``.
      rhs_gv_fn: (y, t) -> (dy, ug, vg), the same dy plus the raw-ky group
        velocity of the evaluated state (``models.ray.rhs_and_gv``); not
        called on CUDA.
      y, f: (5, R) state and its rhs (FSAL carry); t, h, prev_lon,
        prev_lat: (R,).
      bounds: (G,) non-decreasing output times.
      state0: None, or the (hist, rejected, new_step, lane_att, idx) tail
        of an earlier return to resume a suspended group (the entry prefill
        is then skipped; it may be gathered to a lane subset).

    Returns (hist (G, 7, R), y, t, h, f, prev_lon, prev_lat, iters, nfev,
    lane_att, rejected, new_step, idx): iters the batch-wide trip count
    (each lane stops after max_iters trips; a device scalar on CUDA), nfev
    = 6 * iters, lane_att (R,) int32 the step attempts per lane.
    """
    run = _integrate_group_cuda if y.is_cuda else _integrate_group_plain
    return run(rhs_fn, rhs_gv_fn, y, t, h, f, bounds, prev_lon, prev_lat,
               cut_off, rtol, atol, min_step, max_iters, state0)


def _integrate_group_plain(rhs_fn, rhs_gv_fn, y, t, h, f, bounds, prev_lon,
                           prev_lat, cut_off, rtol, atol, min_step,
                           max_iters=1_000_000, state0=None, barrier=False):
    """The plain PyTorch version: the batch-wide JAX loop written out.

    With ``barrier`` a lane is frozen (walked bound by bound, its state
    unchanged) only if its amp is NaN with finite dynamics at the group's
    entry; a lane whose amp turns NaN inside the group keeps stepping. Over
    one bound that is the barrier path's ``integrate_interval``, which
    freezes such a lane only at the next interval's entry.
    """
    if barrier and state0 is not None:
        raise ValueError("barrier semantics decide the frozen lanes at a "
                         "group's entry; a resumed group has none")
    rtol, atol, min_step, cut_off = (as_scalar(x, y.dtype)
                                     for x in (rtol, atol, min_step, cut_off))
    g = bounds.shape[0]
    # The NaN-amp lanes with finite dynamics: walked as frozen on every trip
    # where they are so now, or under ``barrier`` where they were at entry.
    def nan_amp(y):
        return torch.isnan(y[4]) & ~torch.isnan(torch.mean(y[:4], dim=0))

    frozen0 = nan_amp(y) if barrier else None
    if state0 is None:
        hist, rejected, new_step, lane_att, idx, t_shift = (
            group_entry_state(y, bounds))
        t = torch.where(torch.isnan(t_shift), t, t_shift)
    else:
        hist, rejected, new_step, lane_att, idx = (x.clone() for x in state0)
    slot = torch.arange(g, dtype=torch.int32, device=y.device)[:, None]
    nan = torch.full_like(y, float("nan"))
    nan_gv = torch.full_like(y[:2], float("nan"))

    iters = 0
    while iters < max_iters and bool(torch.any(idx < g)):
        done = idx >= g
        bound = bounds[torch.clamp(idx, max=g - 1).long()]
        frozen = ~done & (frozen0 if barrier else nan_amp(y))

        heff = torch.where(new_step, torch.clamp(h, min=min_step), h)
        t_new = t + heff
        t_new = torch.where(t_new > bound, bound, t_new)
        t_new = torch.where(frozen, bound, t_new)
        hstep = t_new - t

        k, y_new = _dp_trial(rhs_fn, y, t, hstep, f)
        y_new = torch.where(frozen[None, :], y, y_new)
        f_new, ug_new, vg_new = rhs_gv_fn(y_new, t_new)
        k.append(f_new)
        error_norm = _exact_error_norm(k, hstep, y, y_new, rtol, atol)

        accept = (error_norm < 1.0) | frozen
        fac_acc, fac_rej = _exact_factors(error_norm, rejected)
        h_next = torch.where(accept, hstep * fac_acc, hstep * fac_rej)
        h_next = torch.where(frozen, h, h_next)

        act = ~done
        upd = act & accept
        t_out = torch.where(upd, t_new, t)
        t_out = torch.where(act & torch.isnan(t_out), bound, t_out)
        crossing = upd & (t_out >= bound)

        y_upd = torch.where(upd[None, :], y_new, y)
        # The kill test at the bound, against the ray's last saved position.
        kill = crossing & ray_mod.kill_mask(y_upd, prev_lon, prev_lat,
                                            cut_off)
        y_sav = torch.where(kill[None, :], nan, y_upd)
        gv_sav = torch.where(kill[None, :], nan_gv,
                             torch.stack([ug_new, vg_new]))
        sel = crossing[None, :] & (slot == idx[None, :])
        hist = torch.where(sel[:, None, :],
                           torch.cat([y_sav, gv_sav])[None], hist)
        # Dead after a crossing: skip the remaining bounds (NaN rows).
        dead_after = crossing & torch.isnan(y_sav[0])
        idx = torch.where(dead_after, g, torch.where(crossing, idx + 1, idx)
                          ).to(torch.int32)

        y = y_sav  # y_upd, NaN where a crossing was killed
        t = t_out
        f = torch.where(upd[None, :], f_new, f)
        h = torch.where(act, h_next, h)
        stepping = act & ~frozen
        rejected = torch.where(stepping, ~accept, rejected)
        new_step = torch.where(stepping, accept, new_step)
        prev_lon = torch.where(crossing, y_sav[0], prev_lon)
        prev_lat = torch.where(crossing, y_sav[1], prev_lat)
        lane_att = lane_att + stepping.to(torch.int32)
        iters += 1

    return (hist, y, t, h, f, prev_lon, prev_lat, iters, 6 * iters, lane_att,
            rejected, new_step, idx)


def _integrate_group_cuda(rhs_fn, rhs_gv_fn, y, t, h, f, bounds, prev_lon,
                          prev_lat, cut_off, rtol, atol, min_step,
                          max_iters=1_000_000, state0=None, instance=None):
    """Launch the exact-group kernel: the whole group in one launch, one
    thread (or a team of threads) per lane as ``exact_instance``
    chooses, or as ``instance`` says. The entry state (or the resumed
    ``state0``) is read inside the kernel. A float64 state over a float32
    background (f in the background's dtype) takes the mixed instance."""
    global EXACT_LAUNCHES
    if not isinstance(rhs_fn, RayRHS):
        raise TypeError("on CUDA the exact-group kernel integrates the ray "
                        "RHS only: pass models.ray.RayRHS(bg)")
    bg = rhs_fn.bg
    key = kernels.state_key(y, bg.fields)
    dev, dt = y.device, y.dtype
    if y.ndim != 2 or y.shape[0] != 5:
        raise ValueError(f"y must be (5, R); got {tuple(y.shape)}")
    r = y.shape[1]
    g = bounds.shape[0]
    if bounds.ndim != 1 or g < 1:
        raise ValueError("bounds must be a non-empty (G,) tensor")
    for name, x, shape in (("y", y, (5, r)), ("t", t, (r,)), ("h", h, (r,)),
                           ("prev_lon", prev_lon, (r,)),
                           ("prev_lat", prev_lat, (r,)),
                           ("bounds", bounds, (g,))):
        kernels.check_tensor(x, name, device=dev, dtype=dt, shape=shape)
    kernels.check_tensor(f, "f", device=dev, dtype=key[1], shape=(5, r))
    variant, bg_args = ray_mod.kernel_background(bg, dev, key[1], r)
    rtol, atol, min_step, cut_off = (as_scalar(x, dt)
                                     for x in (rtol, atol, min_step, cut_off))

    # The carry and the resumable tail, updated in place by the kernel.
    y, t, h, f, prev_lon, prev_lat = (
        x.clone() for x in (y, t, h, f, prev_lon, prev_lat))
    if state0 is None:
        hist = torch.empty((g, 7, r), dtype=dt, device=dev)
        rejected = torch.empty(r, dtype=torch.bool, device=dev)
        new_step = torch.empty_like(rejected)
        lane_att = torch.empty(r, dtype=torch.int32, device=dev)
        idx = torch.empty_like(lane_att)
    else:
        hist, rejected, new_step, lane_att, idx = (x.clone() for x in state0)
        for name, x, shape, xdt in (
                ("hist", hist, (g, 7, r), dt),
                ("rejected", rejected, (r,), torch.bool),
                ("new_step", new_step, (r,), torch.bool),
                ("lane_att", lane_att, (r,), torch.int32),
                ("idx", idx, (r,), torch.int32)):
            kernels.check_tensor(x, name, device=dev, dtype=xdt, shape=shape)
    trips = torch.empty(r, dtype=torch.int32, device=dev)
    kernels.launch(
        f"rwrt_exact_group{variant}", key, *bg_args, y, t, h, f, prev_lon,
        prev_lat, rejected, new_step, lane_att,
        idx, trips, hist, bounds, g, r, int(state0 is not None), cut_off,
        rtol, atol, min_step, int(max_iters), kernels.instance_id(
            instance or exact_instance(r, key, run=False, variant=variant)),
        kernels.stream(dev))
    EXACT_LAUNCHES += 1
    iters = trips.max() if r else 0
    return (hist, y, t, h, f, prev_lon, prev_lat, iters, 6 * iters, lane_att,
            rejected, new_step, idx)


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

        k, y_new = _dp_trial(rhs_fn, y, t, hstep, f0)
        f_new = rhs_fn(y_new, t_new)
        k.append(f_new)
        error_norm = _error_norm(k, hstep, y, y_new, rtol, atol)

        nan_err = torch.isnan(error_norm)
        dead_now = torch.isnan(y[0])
        at_floor = hstep <= min_step
        accept = torch.where(nan_err, dead_now | at_floor, error_norm < 1.0)
        raw = SAFETY * lane_op(torch.pow, error_norm, ERROR_EXPONENT)
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
    in one launch. The entry state is computed inside the kernel. A float64
    state over a float32 background (f in the background's dtype) takes the
    mixed instance."""
    global LAUNCHES
    if not isinstance(rhs_fn, RayRHS):
        raise TypeError("on CUDA the dense-group kernel integrates the ray "
                        "RHS only: pass models.ray.RayRHS(bg)")
    bg = rhs_fn.bg
    key = kernels.state_key(y, bg.fields)
    dev, dt = y.device, y.dtype
    if y.ndim != 2 or y.shape[0] != 5:
        raise ValueError(f"y must be (5, R); got {tuple(y.shape)}")
    r = y.shape[1]
    g = bounds.shape[0]
    for name, x, shape in (("y", y, (5, r)), ("t", t, (r,)), ("h", h, (r,)),
                           ("bounds", bounds, (g,))):
        kernels.check_tensor(x, name, device=dev, dtype=dt, shape=shape)
    kernels.check_tensor(f, "f", device=dev, dtype=key[1], shape=(5, r))
    variant, bg_args = ray_mod.kernel_background(bg, dev, key[1], r)
    if g < 1:
        raise ValueError("bounds must be non-empty")
    rtol, atol, min_step, pin_limit, pin_mwn = _scalar_args(
        dt, rtol, atol, min_step, pin_limit, pin_mwn)

    y, t, h, f = (x.clone() for x in (y, t, h, f))  # updated in place
    hist = torch.empty((g, 5, r), dtype=dt, device=dev)
    rejected = torch.empty(r, dtype=torch.bool, device=dev)
    new_step = torch.empty(r, dtype=torch.bool, device=dev)
    lane_att = torch.empty(r, dtype=torch.int32, device=dev)
    kernels.launch(
        f"rwrt_dense_group{variant}", key, *bg_args, y, t, h, f, rejected,
        new_step, lane_att, hist, bounds, g, r,
        rtol, atol, min_step, int(max_iters), pin_limit, pin_mwn,
        kernels.stream(dev))
    LAUNCHES += 1
    iters = lane_att.max() if r else 0
    return (hist, y, t, h, f, iters, 6 * iters, lane_att, rejected,
            new_step)
