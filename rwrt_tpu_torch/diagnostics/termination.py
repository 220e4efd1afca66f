"""Per-ray termination accounting (port of
``rwrt_tpu/diagnostics/termination.py``: ``TerminationReport``,
``death_steps`` and ``analyze``, plain numpy over the host trajectories).

The reference kills rays by per-ray masks (latitude out of range, runaway
|m|, excessive haversine displacement) and NaN-fills them, recording
nothing about when or why a ray died. ``analyze`` reconstructs the death
step and survival per output step from the trajectory arrays, with a
coarse cause (the last live latitude near a pole). ``classify``, the exact
cause from re-running each killing interval, is not ported yet.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np

from rwrt_tpu_torch.convert import host


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


def classify(traj, bs, config, max_rays: int = 1_000_000):
    """Exact per-ray death causes by re-running the killing interval: not
    ported yet."""
    raise NotImplementedError(
        "termination.classify is not ported yet (ROADMAP Slice 4, "
        "diagnostics); analyze gives the coarse causes")
