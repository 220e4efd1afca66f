"""Generic batched adaptive ODE integration (standalone Dormand-Prince 5(4)).

Port of ``rwrt_tpu/solvers/ode.py``: the general-purpose integrator the
reference vendors beside its ray solver (arbitrary ODEs, not just the ray
equations). A batch of n independent lanes, each with its own (t, h,
accept/reject) controller, FSAL, and the tableau and controller constants
of the ray path (``solvers/rk45.py``); and the fixed-step classical RK4
driver with the reference's time bookkeeping.

Plain PyTorch on the device of the initial state: the user's ``f`` is a
Python callable, so no kernel can take it. The JAX ``lax.while_loop`` per
output interval and ``lax.scan`` over them become Python loops; a lane's
trips, the batch-wide iteration count and ``nfev`` are the JAX package's.
The flagship ray integration does NOT go through this module.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from rwrt_tpu_torch.solvers.rk45 import (DP_A, DP_B, DP_C, DP_E,
                                         ERROR_EXPONENT, MAX_FACTOR,
                                         MIN_FACTOR, SAFETY, validate_tol)


class OdeSolution(NamedTuple):
    """ys: (nt, d, n) states at ``t_eval``; status: (n,) int8 per lane
    (0 = ok, 1 = failed mid-run (non-finite RHS at the step floor), 2 = ran
    out of iterations); nfev: total RHS evaluations; iters: controller
    iterations actually executed (0-d int64 tensors)."""

    ys: torch.Tensor
    status: torch.Tensor
    nfev: torch.Tensor
    iters: torch.Tensor


def _rms_norm(x):
    return torch.sqrt(torch.mean(torch.square(x), dim=0))


def _dp_step(f, t, y, h, k1):
    """One Dormand-Prince 5(4) attempt for every lane.

    t, h: (n,); y, k1: (d, n). Returns (y5, k7, err) where err is the
    embedded 4th/5th-order error estimate (d, n). 6 fresh RHS evaluations
    (k1 is the FSAL carry).
    """
    ks = [k1]
    for i in range(1, 6):
        dy = ks[0] * DP_A[i][0]
        for j in range(1, i):
            if DP_A[i][j] != 0.0:
                dy = dy + ks[j] * DP_A[i][j]
        ks.append(f(t + DP_C[i] * h, y + dy * h))
    y5 = ks[0] * DP_B[0]
    for j in range(1, 6):
        if DP_B[j] != 0.0:
            y5 = y5 + ks[j] * DP_B[j]
    y5 = y + y5 * h
    k7 = f(t + h, y5)
    ks.append(k7)
    err = ks[0] * DP_E[0]
    for j in range(1, 7):
        if DP_E[j] != 0.0:
            err = err + ks[j] * DP_E[j]
    return y5, k7, err * h


def solve_ivp_rk4(f: Callable, y0, *, t0=0.0, t_bound, dt):
    """Fixed-step classical RK4 over [t0, t_bound] for a batch of lanes.

    Uniform steps of ``dt`` from ``t0``, with the final step clamped to
    land exactly on ``t_bound`` (the reference's ``simple_rk4``). ``f(t,
    y)``: t (n,) per-lane times, y (d, n) -> (d, n), as for
    :func:`solve_ivp_batched`; pass y0 (d,) for a single lane.

    Returns ``(ys, ts)``: ys (nt, d[, n]) including the initial state,
    ts (nt,) the step times (host-computed with the reference's exact
    accumulation bookkeeping).
    """
    y0 = torch.as_tensor(y0)
    squeeze = y0.ndim == 1
    if squeeze:
        y0 = y0[:, None]
    n = y0.shape[1]
    dtype, dev = y0.dtype, y0.device

    # Host-side time bookkeeping, as the reference loop keeps it:
    # accumulated this_t/next_t, final step this_dt = dt - next_t + t_bound.
    t0f, tbf, dtf = float(t0), float(t_bound), float(dt)
    ts = [t0f]
    stages = []  # (step start time, step size)
    this_t, next_t = t0f, t0f + dtf
    while this_t < tbf:
        h = dtf
        if next_t > tbf:
            h = dtf - next_t + tbf
            next_t = tbf
        if h <= 0.0:
            break
        ts.append(next_t)
        stages.append((this_t, h))
        this_t += dtf
        next_t += dtf

    def scalar(x):
        return torch.tensor(x, dtype=torch.float64).to(device=dev,
                                                       dtype=dtype)

    ys = [y0]
    y = y0
    for t, h in stages:
        t, h = scalar(t), scalar(h)
        tv = t.expand(n)
        k1 = f(tv, y)
        k2 = f(tv + 0.5 * h, y + 0.5 * h * k1)
        k3 = f(tv + 0.5 * h, y + 0.5 * h * k2)
        k4 = f(tv + h, y + h * k3)
        y = y + h / 6.0 * (k1 + 2.0 * k2 + 2.0 * k3 + k4)
        ys.append(y)
    ys = torch.stack(ys)
    if squeeze:
        ys = ys[:, :, 0]
    return ys, torch.tensor(ts, dtype=torch.float64).to(device=dev,
                                                        dtype=dtype)


def solve_ivp_batched(
    f: Callable,
    y0,
    t_eval,
    *,
    t0=0.0,
    rtol=1e-6,
    atol=1e-6,
    first_step=None,
    min_step=None,
    max_step=None,
    max_iters: int = 100_000,
) -> OdeSolution:
    """Integrate dy/dt = f(t, y) for a batch of independent lanes.

    f(t, y): t (n,) per-lane times, y (d, n) states -> (d, n) derivatives.
    Each lane runs its own adaptive controller (per-lane t, h,
    accept/reject); lanes never couple, so a batched run equals each lane
    run alone. For a single trajectory pass y0 (d,).

    y0: (d,) or (d, n) initial state at t0. t_eval: increasing output
    times (> t0); integration steps to each bound exactly (clamped step).
    min_step defaults to 1e-3 * (t_eval[0] - t0); max_step (None =
    unbounded) caps the attempted step.

    Per-lane failure: a lane whose RHS goes non-finite at the step floor is
    frozen at NaN with status 1 (the batch continues); a lane still short
    of a bound after max_iters trips of that interval gets status 2.
    """
    y0 = torch.as_tensor(y0)
    squeeze = y0.ndim == 1
    if squeeze:
        y0 = y0[:, None]
    dtype, dev = y0.dtype, y0.device
    n = y0.shape[1]
    t_eval = torch.as_tensor(t_eval, dtype=torch.float64).to(device=dev,
                                                             dtype=dtype)
    t0 = torch.tensor(float(t0), dtype=torch.float64).to(device=dev,
                                                        dtype=dtype)
    rtol = validate_tol(rtol, dtype)
    atol = float(torch.tensor(float(atol), dtype=torch.float64).to(dtype))
    if min_step is None:
        min_step = 1e-3 * (float(t_eval[0]) - float(t0))
    min_step = float(torch.tensor(float(min_step),
                                  dtype=torch.float64).to(dtype))
    if max_step is not None and float(max_step) <= 0.0:
        raise ValueError("max_step must be positive")
    max_step = torch.tensor(float("inf") if max_step is None
                            else float(max_step),
                            dtype=torch.float64).to(device=dev, dtype=dtype)

    t = t0.expand(n).clone()
    k1 = f(t, y0)
    if first_step is None:
        # Hairer-style initial step from the first RHS sample.
        scale = atol + torch.abs(y0) * rtol
        d0 = _rms_norm(y0 / scale)
        d1 = _rms_norm(k1 / scale)
        h0 = torch.where((d0 < 1e-5) | (d1 < 1e-5),
                         torch.full_like(d0, 1e-6), 0.01 * d0 / d1)
        h = torch.minimum(h0.to(dtype), t_eval[0] - t0)
    else:
        h = torch.full((n,), float(first_step), dtype=dtype, device=dev)
    status = torch.zeros(n, dtype=torch.int8, device=dev)
    # A lane whose initial state or first RHS sample is non-finite can
    # never integrate: frozen at NaN with status 1 up front.
    bad0 = ~(torch.isfinite(y0).all(dim=0) & torch.isfinite(k1).all(dim=0))
    status = torch.where(bad0, torch.ones_like(status), status)
    y = torch.where(bad0[None, :], torch.full_like(y0, float("nan")), y0)
    h = torch.where(bad0, torch.full_like(h, min_step), h)

    nfev = torch.tensor(n, dtype=torch.int64, device=dev)  # the FSAL seed
    iters = 0
    ys = []
    nan = torch.full_like(y, float("nan"))
    for t_bound in t_eval:
        done = (t >= t_bound) | (status > 0)
        it = 0
        while it < max_iters and bool(torch.any(~done)):
            active = ~done
            h_step = torch.minimum(torch.clamp(t_bound - t, min=0.0),
                                   torch.minimum(h, max_step))
            y5, k7, err = _dp_step(f, t, y, h_step, k1)
            scale = atol + torch.maximum(torch.abs(y), torch.abs(y5)) * rtol
            err_norm = _rms_norm(err / scale)
            accept = err_norm <= 1.0  # NaN -> False (reject)
            # Dead lane: error not finite and no room left to shrink.
            dead = active & ~torch.isfinite(err_norm) & (h_step <= min_step)
            raw = SAFETY * err_norm ** ERROR_EXPONENT
            factor = torch.where(accept,
                                 torch.clamp(raw, MIN_FACTOR, MAX_FACTOR),
                                 torch.clamp(raw, min=MIN_FACTOR))
            factor = torch.where(torch.isfinite(factor), factor,
                                 torch.full_like(factor, MIN_FACTOR))
            upd = active & accept & ~dead
            y = torch.where(upd[None, :], y5, y)
            k1 = torch.where(upd[None, :], k7, k1)
            t = torch.where(upd, t + h_step, t)
            h = torch.where(active & ~dead,
                            torch.clamp(h_step * factor, min=min_step), h)
            y = torch.where(dead[None, :], nan, y)
            status = torch.where(dead, torch.ones_like(status), status)
            done = done | dead | (t >= t_bound)
            nfev = nfev + 6 * active.sum()
            it += 1
        status = torch.where(~done & (status == 0),
                             torch.full_like(status, 2), status)
        iters += it
        ys.append(y)
    ys = torch.stack(ys)
    if squeeze:
        ys = ys[:, :, 0]
        status = status[0]
    return OdeSolution(ys=ys, status=status, nfev=nfev,
                       iters=torch.tensor(iters, dtype=torch.int64))
