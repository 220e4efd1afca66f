"""Per-ray termination accounting (port of
``rwrt_tpu/diagnostics/termination.py``).

The reference kills rays by per-ray masks (latitude out of range, runaway
|m|, excessive haversine displacement) and NaN-fills them, recording
nothing about when or why a ray died. ``analyze`` reconstructs the death
step and survival per output step from the trajectory arrays (plain numpy
over the host trajectories), with a coarse cause (the last live latitude
near a pole). ``classify`` gives the exact cause: it re-runs each dead
ray's killing interval in one batch on the basic state's device and
applies the kill masks to the recovered candidate state. On the card the
RK45 re-run is one launch of the interval kernel
(``rk45.integrate_interval_rays``: ``csrc/interval.cu``, each lane's loop
to its own bound in registers), after one launch of the entry-stage
kernel for the initial step (``tracer.entry_stage``: ``csrc/entry.cu``,
at each lane's own time over a time-varying background); the RK4
re-run's one step is one launch of the step kernel
(``rk4.rk4_step_rays``: ``csrc/rk4_run.cu``, each lane's four stages in
registers from its own time).
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch

from rwrt_tpu_torch.convert import host

#: The exact causes, by the label ``cause_labels`` gives a dead ray.
CAUSES = ("polar", "jump", "runaway", "other")


class TerminationReport(NamedTuple):
    """death_step: (3, nsource, nzwn) int; -1 = never born (no root),
    nt = survived to the end. counts maps cause labels to ray counts."""

    death_step: np.ndarray
    alive_frac: np.ndarray   # (nt,) fraction of born rays alive per step
    counts: Dict[str, int]


def death_steps(traj, block: int = 64):
    """(death_step, born, alive_per_step): host accounting in time blocks.

    A ray is BORN iff its initial amplitude is finite: rootless lanes keep
    their (finite) seed position in the history forever, so finiteness of
    lon would mislabel them as surviving rays.

    The scan runs ``block`` output steps at a time so memmap-backed
    trajectories (``trace_rays_chunked(stream_dir=...)``) never materialize
    a full-history temporary.
    """
    amp = host(traj.amp)
    nt = amp.shape[0]
    shape = amp.shape[1:]
    born = np.isfinite(np.asarray(amp[0]))
    first_dead = np.full(shape, nt, dtype=np.int64)
    undead = np.ones(shape, dtype=bool)
    alive_per_step = np.empty(nt, dtype=np.int64)
    for t0 in range(0, nt, block):
        fin = np.isfinite(np.asarray(amp[t0:t0 + block]))
        alive_per_step[t0:t0 + fin.shape[0]] = fin.sum(
            axis=tuple(range(1, fin.ndim)))
        dead = ~fin
        newly = undead & dead.any(axis=0)
        first_dead[newly] = t0 + dead.argmax(axis=0)[newly]
        undead &= ~newly
    return np.where(born, first_dead, -1), born, alive_per_step


def analyze(traj) -> TerminationReport:
    """Host-side accounting; coarse causes."""
    lat = host(traj.lat)
    nt = lat.shape[0]
    death_step, born, alive_counts = death_steps(traj)

    n_born = max(int(born.sum()), 1)
    alive_frac = alive_counts / n_born

    died = (death_step >= 1) & (death_step < nt)
    # Last live latitude: a ray with |lat| near the polar cap at its final
    # saved point almost certainly hit a latitude kill next step. The fancy
    # gather touches one element per ray, so memmaps page in only the rows
    # that hold deaths.
    d = np.clip(death_step, 1, nt - 1)
    ii = np.indices(death_step.shape)
    la_prev = np.asarray(lat[d - 1, ii[0], ii[1], ii[2]])
    near_pole = died & np.isfinite(la_prev) & (np.abs(la_prev)
                                               > np.radians(80.0))
    counts = {
        "no_root": int((~born).sum()),
        "survived": int((death_step == nt).sum()),
        "polar": int(near_pole.sum()),
        "unclassified": int((died & ~near_pole).sum()),
    }
    return TerminationReport(
        death_step=death_step, alive_frac=alive_frac, counts=counts
    )


def _gather(a, index, device, dtype) -> torch.Tensor:
    """a[index] (one element per dead ray) on ``device`` in ``dtype``: a
    tensor is gathered on its own device, numpy (memmaps) on the host."""
    if torch.is_tensor(a):
        a = a[tuple(torch.as_tensor(i, device=a.device) for i in index)]
    else:
        a = torch.from_numpy(np.asarray(a)[index])
    return a.to(device=device, dtype=dtype)


def cause_labels(traj, bs, config, death_step, rhs=None,
                 max_iters: int = 10_000, stats=None) -> np.ndarray:
    """The exact cause (an index into ``CAUSES``) of each ray that died
    after its seed step, in ``np.argwhere`` order of ``death_step``
    (``analyze``'s).

    One batched re-run on ``bs``'s device: each dead ray's last saved state
    advanced over its killing interval, at its own time (t0 = (d - 1) *
    tstep, bound d * tstep per lane), with the configured integrator (RK4
    one step; RK45 from a fresh Hairer initial step through
    ``integrate_interval`` to the lane's bound, ``max_iters`` trips at
    most, the JAX package's 10,000 by default), then the kill masks on the
    candidate state:

      polar    -- |lat| >= pi/2 (and the candidate is not NaN)
      jump     -- haversine displacement >= cut_off
      runaway  -- NaN candidate lon or ky (the RHS's |m| >= 100 or
                  mid-stage latitude mask)
      other    -- death not reproduced by the re-run

    ``rhs`` (bg, y, t) -> (dy, err) evaluates the RHS: by default the
    RK4 re-run's step through ``rk4.rk4_step_rays`` and the RK45 re-run's
    initial step through ``tracer.entry_stage`` and its loop through
    ``rk45.integrate_interval_rays`` (on a CUDA state one launch of the
    step kernel, or one of the entry kernel and one of the interval
    kernel; the plain versions on a CPU one); a callable
    (``lambda bg, y, t: ray._rhs_core(bg, y, t, False)[:2]``, or
    ``ray.rhs``) runs the plain step or loop over it: ``rk4.rk4_step``,
    ``rk45.integrate_interval``. ``stats``
    (a dict, or None) receives the re-run's candidate state (``"state"``,
    (5, n) on ``bs``'s device), its entry (``"entry"``: y and t0; in RK45
    also h0 and the bounds) and, in RK45, each lane's trips
    (``"lane_att"``, (n,) int32).
    """
    from rwrt_tpu_torch import tracer as tracer_mod
    from rwrt_tpu_torch.constants import pi
    from rwrt_tpu_torch.models import ray as ray_mod
    from rwrt_tpu_torch.solvers import rk4 as rk4_mod
    from rwrt_tpu_torch.solvers import rk45 as rk45_mod

    plain = rhs is not None
    nt = traj.lon.shape[0]
    died = (death_step >= 1) & (death_step < nt)
    idx = np.argwhere(died)
    d = death_step[died]
    if idx.shape[0] == 0:
        return np.zeros(0, np.int8)
    stats = {} if stats is None else stats
    dtype = bs.fields.dtype
    dev = bs.fields.device
    index = (d - 1, idx[:, 0], idx[:, 1], idx[:, 2])
    y = torch.stack([_gather(getattr(traj, k), index, dev, dtype)
                     for k in ("lon", "lat", "kx", "ky", "amp")])

    def per_lane(x):
        return torch.as_tensor(x, dtype=torch.float64).to(device=dev,
                                                          dtype=dtype)

    t0 = per_lane((d - 1) * config.tstep)
    bound = per_lane(d * config.tstep)
    bg = tracer_mod.make_background(bs, config.freq)
    cut_off = rk45_mod.as_scalar(config.cut_off_rad, dtype)
    if config.integrator == "rk4":
        if plain:
            y_new = rk4_mod.rk4_step(bg, y, config.tstep, t0, rhs=rhs)
        else:
            y_new = rk4_mod.rk4_step_rays(bg, y, config.tstep, t0)
        stats["entry"] = (y, t0)
    else:
        def rhs_fn(yy, tt=0.0):
            return rhs(bg, yy, tt)[0]

        rtol = rk45_mod.validate_tol(config.rtol, dtype)
        atol = rk45_mod.as_scalar(config.atol, dtype)
        min_step = rk45_mod.as_scalar(
            min(config.min_step_factor * config.tstep,
                config.tstep * 1e-3), dtype)
        if plain:
            h0 = rk45_mod.select_initial_step(rhs_fn, y, rhs_fn(y, t0), rtol,
                                              atol, t0)
            out = rk45_mod.integrate_interval(
                rhs_fn, y, t0, h0, bound, rtol, atol, min_step,
                max_iters=max_iters)
        else:
            h0 = tracer_mod.entry_stage(bg, y, t0, rtol, atol)[0]
            out = rk45_mod.integrate_interval_rays(
                bg, y, t0, h0, bound, rtol, atol, min_step,
                max_iters=max_iters)
        y_new = out[0]
        stats["entry"] = (y, t0, h0, bound)
        stats["lane_att"] = out[5]
    stats["state"] = y_new
    nan_cand = torch.isnan(y_new[0]) | torch.isnan(y_new[3])
    lat_kill = torch.abs(y_new[1]) >= 0.5 * pi
    ddis = ray_mod.haversine(y_new[0], y_new[1], y[0], y[1])
    jump_kill = ddis >= cut_off
    nan_cand, lat_kill, jump_kill = (host(x) for x in (nan_cand, lat_kill,
                                                       jump_kill))
    polar = lat_kill & ~nan_cand
    jump = jump_kill & ~nan_cand & ~polar
    labels = np.full(nan_cand.shape, CAUSES.index("other"), np.int8)
    labels[polar] = CAUSES.index("polar")
    labels[jump] = CAUSES.index("jump")
    labels[nan_cand] = CAUSES.index("runaway")
    return labels


def classify(traj, bs, config,
             max_rays: int = 1_000_000) -> TerminationReport:
    """Exact per-ray death causes by re-running the killing interval
    (``cause_labels``), counted under ``CAUSES`` beside ``analyze``'s
    no_root and survived."""
    base = analyze(traj)
    death_step = base.death_step
    nt = traj.lon.shape[0]
    n_dead = int(((death_step >= 1) & (death_step < nt)).sum())
    counts = dict(base.counts)
    counts.pop("polar", None)
    counts.pop("unclassified", None)
    counts.update({c: 0 for c in CAUSES})
    if n_dead == 0:
        return TerminationReport(death_step, base.alive_frac, counts)
    if n_dead > max_rays:
        raise ValueError(f"{n_dead} dead rays exceeds max_rays")
    labels = cause_labels(traj, bs, config, death_step)
    for i, c in enumerate(CAUSES):
        counts[c] = int((labels == i).sum())
    return TerminationReport(death_step, base.alive_frac, counts)
