"""What decides ``correct``: the program's results against the plain
reference (``portbench/reference``), recomputed in float64 from the inputs
the harness handed the program. Each number compared is a worst case over
every value it covers, a value's gap being |program - reference| / (1 +
|reference|) (``gap``), and 1 where one side is NaN and the other is not:

- ``state_gap``: each member's prepared state, every field of the
  derivative stack, beta_M, Ks and q, the gap taken over the field's
  largest |value| instead;
- ``seed_gap``: row 0 of every ray judged (position, wavenumbers, amp,
  ug0, vg0) against the reference's seeding;
- ``step_gap``: every later row of every ray judged against one reference
  RK4 step from the program's own row before it, all seven fields.

Rays through this background are chaotic: float64 runs whose seeds differ
in the last bit part by up to 0.4 rad in 1 % of rays over 90 days, so a
row is judged from the row before it, and the start by itself.

The rays judged: every ray of the window's last request, and ``RAYS`` rays
of each of ``REQUESTS`` requests drawn from the seed (``Sampler``). A
request that raises is no answer: ``correct`` also needs no request of the
window to have failed. The limits are the cell's
``portbench/limits/<cell>.json``.
"""

from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Dict, List, NamedTuple

import numpy as np
import torch

from portbench.reference import rays, state

#: Requests of a window sampled, and rays taken from each.
REQUESTS = 32
RAYS = 128
#: Reference rows stepped at once.
STEP_ROWS = 64


def gap(p: torch.Tensor, r: torch.Tensor, scale=None) -> float:
    """The widest gap of p against r (one shape): |p - r| / scale, scale
    1 + |r| by default; 1 where one side is NaN and the other is not, and
    where the difference is NaN (infinities)."""
    p, r = p.double(), r.to(p.device, torch.float64)
    pn, rn = torch.isnan(p), torch.isnan(r)
    d = (p - r).abs() / ((1 + r.abs()) if scale is None else scale)
    d = torch.where(pn & rn, 0.0, torch.where(pn | rn | torch.isnan(d),
                                              1.0, d))
    return float(d.max()) if d.numel() else 0.0


class Judged(NamedTuple):
    """Rows the program produced: ``rows`` (7, nt, K) the seven fields
    (lon, lat, kx, ky, amp, ug, vg) of rays ``idx`` (K,), indices into the
    request's rays, members side by side."""

    rows: torch.Tensor
    idx: torch.Tensor


class Reference:
    """The reference over one run's inputs: each member's basic state, the
    sampler over them and every ray's seed, in ``dtype`` (the control's
    below float64), the states computed in ``field_dtype`` (default
    ``dtype``)."""

    def __init__(self, config: dict, inputs, device, dtype=torch.float64,
                 field_dtype=None):
        run = config["run"]
        read = np.dtype(run.get("read_dtype", "float32"))
        self.dtype = dtype
        self.states = [state.prepare(np.asarray(w.u, read),
                                     np.asarray(w.v, read),
                                     field_dtype or dtype, device)
                       for w in inputs.winds]
        self.bg = rays.Background([s.fields for s in self.states],
                                  inputs.winds[0].frame_dt, dtype)
        self.seeds = rays.seed(self.bg, inputs.source_lon, inputs.source_lat,
                               run["zwn"], float(run.get("freq", 0.0)),
                               dtype)
        self.integrator = run.get("integrator", "rk4")
        self.dt = float(run["tstep"])
        self.nt = int(run["ttotal"] / run["tstep"]) + 1
        self.cut_off = float(run.get("cut_off", 0.1)) * self.dt / 3600.0

    def rows(self) -> torch.Tensor:
        """The reference's own rows of every ray (7, nt, R), by RK4 from the
        seeds (the control)."""
        if self.integrator != "rk4":
            raise ValueError("the reference integrates RK4 runs only")
        ys, ugs, vgs = rays.run_rk4(self.bg, self.seeds, self.dt, self.nt,
                                    self.cut_off)
        return torch.cat([ys.permute(1, 0, 2), ugs[None], vgs[None]])

    def state_gap(self, got) -> float:
        """The widest gap of prepared states ``got`` (each with fields,
        betam, ks, q) over each field's largest |value|."""
        worst = 0.0
        for p, r in zip(got, self.states, strict=True):
            for key in ("fields", "betam", "ks", "q"):
                a, b = getattr(p, key), getattr(r, key)
                if key != "fields":
                    a, b = a[..., None], b[..., None]
                for i in range(b.shape[-1]):
                    top = torch.nan_to_num(b[..., i].double(), nan=0.0)
                    top = top.abs().max().clamp(min=1e-300)
                    worst = max(worst, gap(a[..., i], b[..., i], top))
        return worst

    def seed_gap(self, j: Judged) -> float:
        s = self.seeds
        i = j.idx.to(s.y0.device)
        ref = torch.cat([s.y0[:, i], s.ug0[None, i], s.vg0[None, i]])
        return gap(j.rows[:, 0].to(ref.device), ref)

    def step_gap(self, j: Judged) -> float:
        """Each row from 1 on against one reference step from the row
        before it."""
        mem = self.seeds.member[j.idx.to(self.seeds.member.device)]
        rows = j.rows.to(mem.device)
        worst = 0.0
        for a in range(1, self.nt, STEP_ROWS):
            b = min(self.nt, a + STEP_ROWS)
            n = b - a
            prev = rows[:5, a - 1:b - 1].to(self.dtype).reshape(5, -1)
            t = torch.arange(a - 1, b - 1, dtype=self.dtype,
                             device=mem.device).repeat_interleave(
                                 rows.shape[-1]) * self.dt
            m = mem.repeat(n)
            y = rays.rk4_step(self.bg, prev, t, self.dt, m, self.cut_off)
            ug, vg = rays.gv_at(self.bg, y, t + self.dt, m)
            ref = torch.cat([y, ug[None], vg[None]]).reshape(7, n, -1)
            worst = max(worst, gap(rows[:, a:b], ref))
        return worst

    def judge(self, got_states, judged: List[Judged]) -> Dict[str, float]:
        """The numbers compared: of prepared states ``got_states`` and of
        the rows ``judged`` (each a ``Judged``)."""
        out = {"state_gap": self.state_gap(got_states),
               "seed_gap": max(self.seed_gap(j) for j in judged)}
        if self.integrator == "rk4":
            out["step_gap"] = max(self.step_gap(j) for j in judged)
        return out


class Sampler:
    """``RAYS`` rays of each of ``REQUESTS`` requests of a window, drawn
    from the seed: the requests among the first ``expected`` (the window's
    likely count), the rays in turn through a permutation of all.
    ``take`` holds a drawn request's rays on the host."""

    def __init__(self, seed: int, n_rays: int, expected: int):
        rng = np.random.default_rng([seed, 3])
        n = max(expected, REQUESTS)
        self.chosen = set(rng.choice(n, REQUESTS, replace=False).tolist())
        self.order = rng.permutation(n_rays)
        self.count = 0
        self.taken: List[Judged] = []

    def take(self, out):
        if self.count in self.chosen:
            k = len(self.taken) * RAYS
            idx = self.order[np.arange(k, k + RAYS) % self.order.size]
            cols = torch.as_tensor(idx, device=out.fields[0][0].device)
            rows = torch.stack([torch.cat(f, dim=1).index_select(1, cols)
                                for f in out.fields])
            self.taken.append(Judged(rows.cpu(), torch.as_tensor(idx)))
        self.count += 1

    def judged(self) -> List[Judged]:
        """The rays taken, as one ``Judged`` (none where none were)."""
        if not self.taken:
            return []
        return [Judged(torch.cat([j.rows for j in self.taken], -1),
                       torch.cat([j.idx for j in self.taken]))]


def whole(out) -> Judged:
    """Every ray of one request's output."""
    rows = torch.stack([torch.cat(f, dim=1) for f in out.fields])
    return Judged(rows, torch.arange(rows.shape[-1]))


class Check(NamedTuple):
    """One number compared, with its limit."""

    name: str
    value: float
    limit: float


def limits(here: Path, cell: str) -> Dict[str, float]:
    """The cell's limits (``portbench/limits/<cell>.json``)."""
    return json.loads((here / "limits" / f"{cell}.json").read_text())


def checks(readings: Dict[str, float], lim: Dict[str, float],
           answered: bool) -> List[Check]:
    """Each limit with its reading; a window that answered nothing reads
    1 (NaN against every value) on each."""
    return [Check(k, readings[k] if answered and k in readings else 1.0,
                  float(v)) for k, v in lim.items()]


def correct(cs: List[Check], failed: int) -> bool:
    return failed == 0 and all(math.isfinite(c.value) and c.value <= c.limit
                               for c in cs)
