"""Adaptive Dormand-Prince 5(4) rays from the equations (``rays.rhs``), in
plain PyTorch: a run at a configuration's own controls, as the port
documents its adaptive runs, written again here from that description, and
a tight integration of single output intervals.

The method: the Dormand-Prince 5(4) tableau (Dormand and Prince 1980), the
5th-order solution kept, its embedded 4th-order one giving the error; the
continuous extension of Shampine (1986), a quartic in theta = (t - t_n) / h.
The error norm is the RMS over the five state components of
h sum_j E_j k_j / (atol + max(|y|, |y_new|) rtol); a step is accepted where
it is under 1, and the next step is h times 0.9 err^(-1/5) clamped to
[0.2, 10], and to at most 1 on the step after a rejection. The first step
is Hairer's (Hairer, Norsett and Wanner, Solving ODEs I, II.4).

A run (``run``), as the port's documentation describes it:

- rtol is raised to 100 units of rounding of the state's precision
  (1.19e-5 for a float32 state); the step floor is min(min_step_factor,
  1e-3) x tstep;
- the output bounds dt, 2 dt, ... are taken ``interval_batch`` at a time
  (the last group padded by repeating the final bound); a ray with a NaN
  component at a group's entry keeps that state at every bound of it;
- every ray starts from its seed at t = 0 with Hairer's step, the stage
  f0 = rhs(y0, 0) carried first-same-as-last; a new step (after an
  accepted one) is at least the floor;
- dense bounds: a ray steps freely, clamped only at its group's last
  bound, and each bound a step spans is emitted from the quartic. A NaN
  error norm rejects at 0.2, unless the state is already NaN or the step
  is at the floor, where it is accepted. With ``pin_limit``, a ray whose
  attempts in the group reach it while |m| >= pin_mwn is NaN-retired, on an
  accepted step or on a rejection at the floor. After the group each bound
  is tested in turn: the ray dies (NaN from there on) where |lat| >= pi/2
  or it moved ``cut_off`` radians or more from its last saved position;
- exact bounds: every step is clamped at the next bound; a NaN error norm
  counts as 0; at each bound reached the same test kills the ray, whose
  remaining bounds in the group stay NaN. A ray whose amp alone is NaN is
  walked through the bounds unchanged, its attempts not counted;
- (ug, vg) of a row are taken at its state and bound time; a ray with a
  NaN component keeps NaN (ug, vg) where its wavenumbers are NaN.

The tight integration (``interval``) runs the same method at rtol = atol =
``TIGHT`` over one interval from given rows, with no floor on accepted
steps: a ray whose trial fails (NaN) is rejected at 0.2 until the step is
below ``TIGHT_FLOOR`` x dt, where the interval kills it.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from portbench.reference import rays

C = (0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0)
A = ((),
     (1 / 5,),
     (3 / 40, 9 / 40),
     (44 / 45, -56 / 15, 32 / 9),
     (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729),
     (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656))
B = (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84)
#: B less the embedded 4th-order weights, over the seven stages (FSAL).
E = (-71 / 57600, 0.0, 71 / 16695, -71 / 1920, 17253 / 339200, -22 / 525,
     1 / 40)
#: The continuous extension: stage i's weight at theta is
#: theta (P[i][0] + theta (P[i][1] + theta (P[i][2] + theta P[i][3]))).
P = ((1.0, -8048581381 / 2820520608, 8663915743 / 2820520608,
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
     (0.0, 40617522 / 29380423, -110615467 / 29380423,
      69997945 / 29380423))
SAFETY, MIN_FACTOR, MAX_FACTOR, EXPONENT = 0.9, 0.2, 10.0, -0.2
#: The tight integration's tolerance, and its floor on a step over tstep.
TIGHT = 1e-9
TIGHT_FLOOR = 1e-3
#: Trips after which the tight integration gives the rays left up
#: (``Interval.unresolved``).
TIGHT_TRIPS = 5000
#: Rays stepped at once.
BLOCK = 1 << 21


class Controls(NamedTuple):
    """A run's controls: tolerances, step floor, output spacing, groups,
    bound mode, kill distance and pin rule (``pin_limit`` None: off)."""

    rtol: float
    atol: float
    min_step: float
    dt: float
    nt: int
    group: int
    dense: bool
    cut_off: float
    pin_limit: Optional[int]
    pin_mwn: float


def controls(run: dict, state_dtype: torch.dtype) -> Controls:
    """The controls of a configuration's ``run`` block for a state of
    ``state_dtype``."""
    dt = float(run["tstep"])
    nt = int(float(run["ttotal"]) / dt) + 1
    rtol = max(float(run.get("rtol", 1e-6)),
               100 * torch.finfo(state_dtype).eps)
    floor = min(float(run.get("min_step_factor", 1e-3)), 1e-3) * dt
    pin = run.get("pin_limit")
    return Controls(rtol, float(run.get("atol", 1e-6)), floor, dt, nt,
                    min(int(run.get("interval_batch", 16)), nt - 1),
                    run.get("bound_mode", "exact") == "dense",
                    float(run.get("cut_off", 0.1)) * dt / 3600.0,
                    None if pin is None else int(pin),
                    float(run.get("pin_mwn", 50.0)))


def norm(x):
    """RMS over the first axis."""
    return torch.sqrt((x * x).mean(0))


def rhs(bg, y, t, member):
    """The ray equations' right-hand side (``rays.rhs``) at times t (N,),
    a NaN time (a ray with no root's first step) read as 0: the ray's own
    values are NaN there."""
    return rays.rhs(bg, y, torch.nan_to_num(t), member)[0]


def stages(bg, y, t, h, f0, member):
    """A trial step of size h (N,) from (y, t) with the carried stage f0:
    (the seven stages, the 5th-order y_new)."""
    k = [f0]
    for s in range(1, 6):
        dy = sum(a * kj for a, kj in zip(A[s], k) if a != 0.0)
        k.append(rhs(bg, y + h * dy, t + C[s] * h, member))
    y_new = y + h * sum(b * kj for b, kj in zip(B, k) if b != 0.0)
    k.append(rhs(bg, y_new, t + h, member))
    return k, y_new


def error_norm(k, h, y, y_new, rtol, atol):
    err = h * sum(e * kj for e, kj in zip(E, k) if e != 0.0)
    return norm(err / (atol + torch.maximum(y.abs(), y_new.abs()) * rtol))


def factors(err, rejected):
    """(after an acceptance, after a rejection) step factors."""
    raw = SAFETY * err.pow(EXPONENT)
    acc = raw.clamp(max=MAX_FACTOR)
    return torch.where(rejected, acc.clamp(max=1.0), acc), \
        raw.clamp(min=MIN_FACTOR)


def dense_at(y, h, k, theta):
    """The quartic at theta (N,) of the step of size h (N,) from y."""
    w = [theta * (p0 + theta * (p1 + theta * (p2 + theta * p3)))
         for p0, p1, p2, p3 in P]
    return y + h * sum(wi * ki for wi, ki in zip(w, k))


def initial_step(bg, y0, f0, t0, member, rtol, atol):
    """Hairer's first step (N,); a small norm is one not above 1e-5 (d0,
    d1) or 1e-15 (both of d1, d2), NaN counting as small."""
    scale = atol + y0.abs() * rtol
    d0, d1 = norm(y0 / scale), norm(f0 / scale)
    h0 = torch.where((d0 < 1e-5) | (d1 < 1e-5), torch.full_like(d0, 1e-6),
                     0.01 * d0 / d1)
    f1 = rhs(bg, y0 + h0 * f0, t0 + h0, member)
    d2 = norm((f1 - f0) / scale) / h0
    h1 = (0.01 / torch.fmax(d1, d2)).pow(0.2)
    small = ~(d1 > 1e-15) & ~(d2 > 1e-15)
    h1 = torch.where(small, (h0 * 1e-3).clamp(min=1e-6), h1)
    return torch.minimum(100 * h0, h1)


class Interval(NamedTuple):
    """One interval from given rows: ``y`` (5, N) at its end, NaN where the
    interval kills the ray; ``m_max``, ``lat_max`` the largest |m| and
    |lat| the ray reached on it; ``unresolved`` (N,) the rays given up."""

    y: torch.Tensor
    m_max: torch.Tensor
    lat_max: torch.Tensor
    unresolved: torch.Tensor


def interval(bg, y, t0, dt: float, member, cut_off: float,
             tol: float = TIGHT) -> Interval:
    """Rays y (5, N), all finite, from times t0 (N,) over dt: the tight
    integration, then the kill test at the bound against the start (|lat|
    >= pi/2, or cut_off radians or more). The rays not yet at their end
    form one queue, ``BLOCK`` of them stepped at a time."""
    n = y.shape[1]
    y0, y = y, y.clone()
    t_end = t0 + dt
    f = torch.empty_like(y)
    h = torch.empty_like(t0)
    for i in range(0, n, BLOCK):
        s = slice(i, i + BLOCK)
        f[:, s] = rhs(bg, y[:, s], t0[s], member[s])
        h[s] = initial_step(bg, y[:, s], f[:, s], t0[s], member[s], tol,
                            tol)
    h = torch.where(torch.isfinite(h) & (h > 0), h, dt)
    t = t0.clone()
    rejected = torch.zeros(n, dtype=torch.bool, device=y.device)
    m_max, lat_max = y[3].abs(), y[1].abs()
    live = torch.arange(n, device=y.device)
    floor = TIGHT_FLOOR * dt
    for _ in range(TIGHT_TRIPS):
        if live.numel() == 0:
            break
        lanes, rest = live[:BLOCK], live[BLOCK:]
        yl, tl, hl, fl, ml = (y[:, lanes], t[lanes], h[lanes],
                              f[:, lanes], member[lanes])
        te = t_end[lanes]
        tn = torch.minimum(tl + hl, te)
        hs = tn - tl
        k, yn = stages(bg, yl, tl, hs, fl, ml)
        err = error_norm(k, hs, yl, yn, tol, tol)
        bad = torch.isnan(err)
        accept = ~bad & (err < 1.0)
        fac_acc, fac_rej = factors(err, rejected[lanes])
        fail = bad & (hs < floor)
        y[:, lanes] = torch.where(accept, yn,
                                  torch.where(fail, math.nan, yl))
        f[:, lanes] = torch.where(accept, k[6], fl)
        t[lanes] = torch.where(accept, tn, tl)
        h[lanes] = torch.where(accept, hs * fac_acc,
                               torch.where(bad, hs * MIN_FACTOR,
                                           hs * fac_rej))
        rejected[lanes] = ~accept
        m_max[lanes] = torch.where(accept, torch.fmax(m_max[lanes],
                                                      yn[3].abs()),
                                   m_max[lanes])
        lat_max[lanes] = torch.where(accept, torch.fmax(lat_max[lanes],
                                                        yn[1].abs()),
                                     lat_max[lanes])
        done = fail | (accept & (tn >= te))
        live = torch.cat([rest, lanes[~done]])
    unresolved = torch.zeros(n, dtype=torch.bool, device=y.device)
    unresolved[live] = True
    y = torch.where(rays.killed(y, y0[0], y0[1], cut_off), math.nan, y)
    return Interval(y, m_max, lat_max, unresolved)


class Run(NamedTuple):
    """A run's rows (7, nt, R): lon, lat, k, m, amp, ug, vg; and ``att``
    (n_groups, R) each group's step attempts of every ray."""

    rows: torch.Tensor
    att: torch.Tensor


class Carry(NamedTuple):
    """What a ray carries from group to group, each (R,) or (5, R), updated
    in place: state, time, next step, FSAL stage, whether the last attempt
    was rejected, whether the next is a new step, the last saved
    position."""

    y: torch.Tensor
    t: torch.Tensor
    h: torch.Tensor
    f: torch.Tensor
    rejected: torch.Tensor
    new_step: torch.Tensor
    plon: torch.Tensor
    plat: torch.Tensor


def run(bg, y0, ug0, vg0, member, ctl: Controls) -> Run:
    """Every ray from its seed (y0 (5, R), ug0, vg0 (R,)) through the run's
    groups, in y0's dtype."""
    dtype, dev = y0.dtype, y0.device
    r, nt = y0.shape[1], ctl.nt
    n_groups = -(-(nt - 1) // ctl.group)
    bounds = (torch.arange(1, n_groups * ctl.group + 1, dtype=dtype,
                           device=dev) * ctl.dt).clamp(max=(nt - 1) * ctl.dt)
    rows = y0.new_full((7, n_groups * ctl.group + 1, r), math.nan)
    rows[:5, 0], rows[5, 0], rows[6, 0] = y0, ug0, vg0
    att = torch.zeros((n_groups, r), dtype=torch.int64, device=dev)
    t = torch.zeros(r, dtype=dtype, device=dev)
    f = rhs(bg, y0, t, member)
    h = initial_step(bg, y0, f, t, member, ctl.rtol, ctl.atol)
    carry = Carry(y0.clone(), t, h, f,
                  torch.zeros(r, dtype=torch.bool, device=dev),
                  torch.ones(r, dtype=torch.bool, device=dev),
                  y0[0].clone(), y0[1].clone())
    group = _dense_group if ctl.dense else _exact_group
    for g in range(n_groups):
        b = bounds[g * ctl.group:(g + 1) * ctl.group]
        sl = slice(1 + g * ctl.group, 1 + (g + 1) * ctl.group)
        rows[:, sl], att[g] = group(bg, carry, b, member, ctl)
    return Run(rows[:, :nt], att)


def _dense_group(bg, c: Carry, bounds, member, ctl: Controls):
    """One group of dense bounds: (rows (7, G, R), attempts (R,))."""
    g, r = bounds.shape[0], c.y.shape[1]
    t_end = bounds[-1]
    frozen = torch.isnan(c.y).any(0)
    hist = torch.full((5, g, r), math.nan, dtype=c.y.dtype,
                      device=c.y.device)
    hist[:, :, frozen] = c.y[:, None, frozen]
    c.t.copy_(torch.where(frozen, t_end, c.t))
    att = torch.zeros(r, dtype=torch.int64, device=c.y.device)
    pin = math.inf if ctl.pin_limit is None else ctl.pin_limit
    while True:
        live = torch.nonzero(c.t < t_end).squeeze(1)
        if live.numel() == 0:
            break
        yl, tl, hl, fl = c.y[:, live], c.t[live], c.h[live], c.f[:, live]
        heff = torch.where(c.new_step[live], hl.clamp(min=ctl.min_step), hl)
        tn = torch.minimum(tl + heff, t_end)
        hs = tn - tl
        k, yn = stages(bg, yl, tl, hs, fl, member[live])
        err = error_norm(k, hs, yl, yn, ctl.rtol, ctl.atol)
        nan = torch.isnan(err)
        accept = torch.where(nan, torch.isnan(yl[0]) | (hs <= ctl.min_step),
                             err < 1.0)
        fac_acc, fac_rej = factors(err, c.rejected[live])
        fac_acc = torch.where(nan, 1.0, fac_acc)
        fac_rej = torch.where(nan, MIN_FACTOR, fac_rej)
        # Every bound the accepted step spans, from the quartic.
        span = (accept[None] & (bounds[:, None] > tl[None])
                & (bounds[:, None] <= tn[None]))
        j, i = torch.nonzero(span, as_tuple=True)
        if j.numel():
            theta = (bounds[j] - tl[i]) / hs[i]
            hist[:, j, live[i]] = dense_at(yl[:, i], hs[i],
                                           [kk[:, i] for kk in k], theta)
        n_att = att[live] + 1
        y_out = torch.where(accept, yn, yl)
        floor_rej = ~accept & (hs <= ctl.min_step * (1 + 1e-6))
        retire = ((accept | floor_rej) & (n_att >= pin)
                  & (y_out[3].abs() >= ctl.pin_mwn))
        y_out = torch.where(retire, math.nan, y_out)
        c.y[:, live] = y_out
        c.t[live] = torch.where(torch.isnan(y_out[0]), t_end,
                                torch.where(accept, tn, tl))
        c.f[:, live] = torch.where(accept, k[6], fl)
        c.h[live] = torch.where(accept, hs * fac_acc, hs * fac_rej)
        c.rejected[live], c.new_step[live] = ~accept, accept
        att[live] = n_att
    # The bounds in turn: the kill test against the last saved position.
    alive = ~frozen
    out = torch.empty((7, g, r), dtype=c.y.dtype, device=c.y.device)
    for b in range(g):
        st = hist[:, b]
        dead = (~alive | rays.killed(st, c.plon, c.plat, ctl.cut_off)
                | torch.isnan(st[0])) & ~frozen
        st = torch.where(dead, math.nan, st)
        alive = alive & ~dead
        c.plon.copy_(torch.where(alive, st[0], c.plon))
        c.plat.copy_(torch.where(alive, st[1], c.plat))
        out[:5, b] = st
        out[5, b], out[6, b] = rays.gv_at(bg, st, bounds[b], member)
    c.y.copy_(torch.where(alive | frozen, c.y, math.nan))
    return out, att


def _exact_group(bg, c: Carry, bounds, member, ctl: Controls):
    """One group of exact bounds: (rows (7, G, R), attempts (R,))."""
    g, r = bounds.shape[0], c.y.shape[1]
    dev = c.y.device
    out = torch.full((7, g, r), math.nan, dtype=c.y.dtype, device=dev)
    nan_dyn = torch.isnan(c.y[:4]).any(0)
    out[:5, :, nan_dyn] = c.y[:, None, nan_dyn]
    idx = torch.where(nan_dyn, g, 0)
    c.t.copy_(torch.where(nan_dyn, bounds[-1], c.t))
    att = torch.zeros(r, dtype=torch.int64, device=dev)
    while True:
        live = torch.nonzero(idx < g).squeeze(1)
        if live.numel() == 0:
            break
        yl, tl, hl, fl = c.y[:, live], c.t[live], c.h[live], c.f[:, live]
        il, ml = idx[live], member[live]
        bound = bounds[il]
        frozen = torch.isnan(yl[4]) & ~torch.isnan(yl[:4]).any(0)
        heff = torch.where(c.new_step[live], hl.clamp(min=ctl.min_step), hl)
        tn = torch.where(frozen, bound, torch.minimum(tl + heff, bound))
        hs = tn - tl
        k, yn = stages(bg, yl, tl, hs, fl, ml)
        yn = torch.where(frozen, yl, yn)
        err = torch.nan_to_num(error_norm(k, hs, yl, yn, ctl.rtol, ctl.atol),
                               nan=0.0)
        accept = (err < 1.0) | frozen
        fac_acc, fac_rej = factors(err, c.rejected[live])
        hn = torch.where(frozen, hl, torch.where(accept, hs * fac_acc,
                                                 hs * fac_rej))
        t_out = torch.where(accept, tn, tl)
        t_out = torch.where(torch.isnan(t_out), bound, t_out)
        cross = accept & (t_out >= bound)
        y_up = torch.where(accept, yn, yl)
        kill = cross & rays.killed(y_up, c.plon[live], c.plat[live],
                                   ctl.cut_off)
        y_sav = torch.where(kill, math.nan, y_up)
        lanes = live[cross]
        ug, vg = rays.gv_at(bg, y_sav[:, cross], tn[cross], ml[cross])
        out[:, il[cross], lanes] = torch.cat([y_sav[:, cross], ug[None],
                                              vg[None]])
        dead = cross & torch.isnan(y_sav[0])
        idx[live] = torch.where(dead, g, torch.where(cross, il + 1, il))
        c.y[:, live] = y_sav
        c.t[live] = t_out
        c.f[:, live] = torch.where(accept, k[6], fl)
        c.h[live] = hn
        stepping = ~frozen
        c.rejected[live] = torch.where(stepping, ~accept, c.rejected[live])
        c.new_step[live] = torch.where(stepping, accept, c.new_step[live])
        c.plon[live] = torch.where(cross, y_sav[0], c.plon[live])
        c.plat[live] = torch.where(cross, y_sav[1], c.plat[live])
        att[live] += stepping.long()
    return out, att
