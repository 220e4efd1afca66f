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
- ``step_gap`` (RK4 runs): every later row of every ray judged against one
  reference RK4 step from the program's own row before it, all seven
  fields;
- ``interval_gap`` (RK45 runs): every later row of every ray judged
  against a tight float64 integration of its output interval
  (``reference.adaptive.interval``) from the program's own row before it,
  the five state fields, and the row's (ug, vg) against the reference's
  at the row's own state and time. A finite row after a NaN one reads 1.
  A death (a NaN row after a finite one) reads 1 unless it is excused:
  the reference's interval kills the ray too; the ray is within
  ``MARGIN`` of the cut_off, pole or |m| < 100 threshold, on the
  reference's interval or in the program's rows, or starts the interval at
  k = 0, where the ray equations divide by k; or the ray's attempts in the
  row's group reached the pin limit (``Judged.att``). A ray the reference
  kills and the program does not reads 1 unless it is within the margin.
  Excused deaths are counted by cause (``excused.reference``,
  ``excused.margin``, ``excused.pin``), and such kills of the reference's
  alone (``excused.reference_only``). A row whose interval the reference
  gives up on (``reference.unresolved``) is not judged;
- ``attempt_gap`` (RK45 runs): |A_program / A_reference - 1|, the step
  attempts of the rays of ``SOURCES`` sources drawn from the seed in the
  window's last request, against the reference's own run of the same rays
  from its own seeds at the configuration's controls
  (``reference.adaptive.run``);
- ``pin_kill_gap`` (RK45 runs with a pin limit): the program's share of
  those rays whose attempts reached the pin limit in some group, less the
  reference's, floored at 0.

Rays through this background are chaotic: float64 runs whose seeds differ
in the last bit part by up to 0.4 rad in 1 % of rays over 90 days, so a
row is judged from the row before it, the start by itself, and an adaptive
controller by its attempts over many rays.

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
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from portbench import work
from portbench.reference import adaptive, rays, state

#: Requests of a window sampled, and rays taken from each.
REQUESTS = 32
RAYS = 128
#: Reference rows stepped at once.
STEP_ROWS = 64
#: Row pairs integrated at once by the tight reference (all of a
#: production-size request: their slowest rays are waited for once).
PAIRS = 1 << 26
#: A death is excused within this share of a threshold: cut_off, the pole
#: (pi/2) and |m| < 100.
MARGIN = 0.01
#: Sources whose rays' attempts are counted (all where there are fewer).
SOURCES = 300


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
    request's rays, members side by side; ``att`` (n_groups, K) the step
    attempts of each ray in each group of an adaptive run (0 for a ray not
    integrated), else None."""

    rows: torch.Tensor
    idx: torch.Tensor
    att: Optional[torch.Tensor] = None


class Reference:
    """The reference over one run's inputs: each member's basic state, the
    sampler over them and every ray's seed, in ``dtype`` (the control's
    below float64), the states computed in ``field_dtype`` (default
    ``dtype``)."""

    def __init__(self, config: dict, inputs, device, dtype=torch.float64,
                 field_dtype=None, seed: int = 0):
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
        if self.integrator != "rk4":
            # The state's precision: float64 for a mixed trace_rays run,
            # else the configuration's (an ensemble runs in its fields').
            wide = (run.get("state_dtype") == "float64"
                    and len(inputs.winds) == 1)
            self.controls = adaptive.controls(
                run, torch.float64 if wide else getattr(torch,
                                                        run["cal_dtype"]))
            ns, nz = len(inputs.source_lon), len(run["zwn"])
            pick = np.random.default_rng([seed, 4]).choice(
                ns, min(ns, SOURCES), replace=False)
            ray = np.arange(len(inputs.winds) * 3 * ns * nz).reshape(
                -1, 3, ns, nz)
            self.counted = torch.as_tensor(
                np.sort(ray[:, :, pick].reshape(-1)))
        self.unresolved = 0

    def rows(self) -> torch.Tensor:
        """The reference's own rows of every ray (7, nt, R), by RK4 from the
        seeds (the control)."""
        if self.integrator != "rk4":
            raise ValueError("the reference integrates RK4 runs only")
        ys, ugs, vgs = rays.run_rk4(self.bg, self.seeds, self.dt, self.nt,
                                    self.cut_off)
        return torch.cat([ys.permute(1, 0, 2), ugs[None], vgs[None]])

    def run(self, lanes=None) -> adaptive.Run:
        """The reference's own RK45 run at the configuration's controls, of
        every ray or of rays ``lanes``, from its seeds."""
        s = self.seeds
        if lanes is not None:
            i = lanes.to(s.y0.device)
            s = rays.Seeds(s.y0[:, i], s.ug0[i], s.vg0[i], s.member[i])
        return adaptive.run(self.bg, s.y0, s.ug0, s.vg0, s.member,
                            self.controls)

    def whole(self) -> Judged:
        """Every ray of the reference's own run, with its attempts: the
        control's rows."""
        r = self.run()
        return Judged(r.rows, torch.arange(r.rows.shape[-1]), r.att.cpu())

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

    def interval_gap(self, j: Judged, excused: Dict[str, int]) -> float:
        """Each row from 1 on against the tight reference interval from
        the row before it; ``excused`` counts the deaths let pass."""
        ctl = self.controls
        dev = self.seeds.member.device
        mem = self.seeds.member[j.idx.to(dev)]
        k = j.idx.numel()
        worst = 0.0
        step = max(1, PAIRS // max(k, 1))
        for a in range(1, self.nt, step):
            b = min(self.nt, a + step)
            prev = j.rows[:, a - 1:b - 1].to(dev, self.dtype)
            cur = j.rows[:, a:b].to(dev, self.dtype)
            n = b - a
            t1 = torch.arange(a, b, dtype=self.dtype, device=dev)[:, None] \
                * self.dt
            t1 = t1.expand(n, k)
            m = mem[None].expand(n, k)
            pdead = torch.isnan(prev[0])
            cdead = torch.isnan(cur[0])
            # A finite value after a NaN row.
            if bool((pdead & ~torch.isnan(cur).all(0)).any()):
                return 1.0
            frozen = ~pdead & torch.isnan(prev[:5]).any(0)
            if bool(frozen.any()):
                ug, vg = rays.gv_at(self.bg, cur[:5, frozen], t1[frozen],
                                    m[frozen])
                worst = max(worst, gap(cur[:, frozen], torch.cat(
                    [prev[:5, frozen], ug[None], vg[None]])))
            live = ~pdead & ~frozen
            if not bool(live.any()):
                continue
            y0, tl, ml = prev[:5, live], t1[live], m[live]
            iv = adaptive.interval(self.bg, y0, tl - self.dt, self.dt, ml,
                                   self.cut_off)
            # A row the reference gave up on is not judged.
            self.unresolved += int(iv.unresolved.sum())
            live[live.clone()] = ~iv.unresolved
            keep = ~iv.unresolved
            y0, tl, ml, yr = y0[:, keep], tl[keep], ml[keep], iv.y[:, keep]
            p1 = cur[:, live]
            rdead = torch.isnan(yr[0])
            pd = cdead[live]
            near = ((iv.m_max[keep] >= rays.MWN_CAP * (1 - MARGIN))
                    | (iv.lat_max[keep] >= rays.HALF_PI * (1 - MARGIN))
                    | (rays.haversine(yr[0], yr[1], y0[0], y0[1])
                       >= self.cut_off * (1 - MARGIN))
                    | (y0[3].abs() >= rays.MWN_CAP * (1 - MARGIN))
                    | (y0[1].abs() >= rays.HALF_PI * (1 - MARGIN))
                    | (p1[3].abs() >= rays.MWN_CAP * (1 - MARGIN))
                    | (p1[1].abs() >= rays.HALF_PI * (1 - MARGIN))
                    | (rays.haversine(p1[0], p1[1], y0[0], y0[1])
                       >= self.cut_off * (1 - MARGIN))
                    | (y0[2] == 0))
            pinned = torch.zeros_like(pd)
            if ctl.pin_limit is not None and j.att is not None:
                grp = ((torch.arange(a, b, device=dev) - 1)
                       // ctl.group)[:, None].expand(n, k)[live]
                col = torch.arange(k, device=dev)[None].expand(n, k)[live]
                pinned = j.att.to(dev)[grp, col] >= ctl.pin_limit
            both = pd & rdead
            excused["reference"] += int(both.sum())
            alone = pd & ~rdead
            excused["pin"] += int((alone & pinned).sum())
            excused["margin"] += int((alone & ~pinned & near).sum())
            ref_only = ~pd & rdead
            excused["reference_only"] += int((ref_only & near).sum())
            if bool((alone & ~pinned & ~near).any()) or bool(
                    (ref_only & ~near).any()):
                return 1.0
            ok = ~pd & ~rdead
            if bool(ok.any()):
                ug, vg = rays.gv_at(self.bg, p1[:5, ok], tl[ok], ml[ok])
                worst = max(worst, gap(p1[:, ok], torch.cat(
                    [yr[:, ok], ug[None], vg[None]])))
        return worst

    def attempts(self, j: Judged) -> Dict[str, float]:
        """``attempt_gap`` and ``pin_kill_gap`` over the counted rays of
        ``j``, a whole request with its attempts."""
        pos = torch.searchsorted(j.idx.cpu(), self.counted)
        got = j.att.cpu()[:, pos].long()
        want = self.run(self.counted).att.cpu()
        a_p, a_r = int(got.sum()), int(want.sum())
        out = {"attempt_gap": abs(a_p / a_r - 1) if a_r else float(a_p > 0)}
        pin = self.controls.pin_limit
        if pin is not None:
            share = [float((x >= pin).any(0).double().mean())
                     for x in (got, want)]
            out["pin_kill_gap"] = max(0.0, share[0] - share[1])
        else:
            out["pin_kill_gap"] = 0.0
        return out

    def judge(self, got_states, judged: List[Judged]) -> Dict[str, float]:
        """The numbers compared: of prepared states ``got_states`` and of
        the rows ``judged`` (each a ``Judged``). An RK45 run's readings
        also hold its excused deaths by cause; its attempts are read from
        the last ``Judged`` that holds every ray and its attempts."""
        out = {"state_gap": self.state_gap(got_states),
               "seed_gap": max(self.seed_gap(j) for j in judged)}
        if self.integrator == "rk4":
            out["step_gap"] = max(self.step_gap(j) for j in judged)
            return out
        excused = {"reference": 0, "margin": 0, "pin": 0,
                   "reference_only": 0}
        out["interval_gap"] = max(self.interval_gap(j, excused)
                                  for j in judged)
        out.update({f"excused.{k}": v for k, v in excused.items()})
        out["reference.unresolved"] = self.unresolved
        n = self.seeds.member.numel()
        whole = [j for j in judged if j.att is not None
                 and j.idx.numel() == n]
        if whole:
            out.update(self.attempts(whole[-1]))
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
            att = ray_attempts(out, cols)
            self.taken.append(Judged(rows.cpu(), torch.as_tensor(idx),
                                     None if att is None else att.cpu()))
        self.count += 1

    def judged(self) -> List[Judged]:
        """The rays taken, as one ``Judged`` (none where none were)."""
        if not self.taken:
            return []
        att = [j.att for j in self.taken]
        return [Judged(torch.cat([j.rows for j in self.taken], -1),
                       torch.cat([j.idx for j in self.taken]),
                       None if att[0] is None else torch.cat(att, -1))]


def ray_attempts(out, cols) -> Optional[torch.Tensor]:
    """The step attempts (n_groups, K) of rays ``cols`` of one request's
    output: its ``lane_att`` columns, each lane mapped to its ray through
    the program's compaction of the born rays (``work``), 0 for a ray not
    integrated; None for a run with no attempts."""
    la = out.lane_att
    if la is None:
        return None
    amp0 = torch.cat([x[0] for x in out.fields[4]])
    born = torch.isfinite(amp0).cpu().numpy()
    idx = work.compact_lane_indices(born)
    lane = np.full(born.size, -1)
    lane[np.arange(born.size) if idx is None else idx] = np.arange(
        born.size if idx is None else idx.size)
    lane = torch.as_tensor(lane, device=la.device)[cols.to(la.device)]
    att = la.index_select(1, lane.clamp(min=0)).long()
    return torch.where(lane >= 0, att, 0)


def whole(out) -> Judged:
    """Every ray of one request's output, with their attempts."""
    rows = torch.stack([torch.cat(f, dim=1) for f in out.fields])
    cols = torch.arange(rows.shape[-1])
    return Judged(rows, cols, ray_attempts(out, cols))


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
