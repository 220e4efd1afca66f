#!/usr/bin/env python3
"""Time and profile the PyTorch/CUDA port's production run on one CUDA card.

    python3 profile_main_path.py [--path dense|rk4|exact|readme]
                                 [--state-dtype compute|float64]
                                 [--warmup 1] [--runs 5]
                                 [--out DIR (profile_out)]
                                 [--tree DIR]
                                 [--kernels [--schedules 8:0,64:32]]
                                 [--exact] [--only REGEX] [--flux]
                                 [--rk4 [--variants no_gv,no_rows]]
                                 [--others] [--spectral]

Runs chip_smoke.py's production seeding (100,800 rays, 30 days, float32)
through ``rwrt_tpu_torch.trace_rays`` with one of three integrators:
``dense`` (the production run: dense RK45, pin (500, 0), interval_batch
60), ``rk4`` (fixed-step RK4) or ``exact`` (exact-bound RK45,
interval_batch 16, no pin); or, with ``readme``, the README's Usage run
(the default 6,615-ray source matrix, 90 days, exact-bound RK45). With
``--state-dtype float64`` the run is in mixed precision (a float64 state
over the float32 background: the whole-run kernels' ``_mix`` instances).
One warm-up run (``--warmup 0`` skips it), then ``--runs`` timed runs (host
wall to a device synchronize), then one run under ``torch.profiler``. Prints the card (``nvidia-smi`` name and power limit),
each wall, the peak device memory, the device span, kernel-busy time and
kernel count of the profiled run (so the device's idle share), the
whole-run kernel's device time, the set-up before it on the device (the
span from the first device event to the whole-run kernel's start, its
events, and the entry-stage and RHS launches among them), the sha256 of
the last run's rows (so that two trees' runs can be seen to be equal), for the adaptive paths each group's most
trips and step attempts and the longest lane's trips over all groups (from
``trace_rays``' ``stats``), whether the run hit the max_iters backstop
(``MaxItersTruncation``: then the run is refused and reported as such),
and the profiler's top operators; the full operator table goes to
``DIR/profile_main_path_<path>.txt`` (``_<path>_float64.txt`` in mixed
precision). The profiler inflates the host side, so the
profiled run's span is longer than an untraced run's wall.

``--kernels`` times the whole-run dense kernel alone instead (CUDA events,
the median of ``--runs`` means of 3 launches) at the shapes of its paths:
the production run in float32, mixed and float64 (its first
``chip_smoke.N_SUBSET`` lanes, and all), over the 31 daily frames (in
float32, mixed and float64), the 4-member ensemble, and the 6- and
17-chunk runs (the chunked driver's kernel time per run); beside each its
warp occupancy in launch order (``warp_occupancy``) and as the repacking
kernel's grid would run it (``repacked_occupancy``); for the production
run its chain floor (its longest lane alone, R = 1), its lanes sorted by
their trips (the occupancy no schedule can pass, difficulty being unknown
before the run) and its 1 % of lanes with the most trips alone.
``--schedules`` times every shape but the chunked runs under each repack
schedule listed (EVERY:TRIGGER, the kernel's ``_repack`` and
``_trigger``; a trigger of 0 ends no window early). ``--only REGEX``
keeps the shapes (of ``--kernels`` or ``--exact``) whose name it
matches.

``--exact`` times the whole-run exact kernel alone instead (CUDA events,
the median of ``--runs`` means of 3 launches, each instance in turns:
Lane, Split, Split, Lane) at the shapes of its float64-state rows and
of its float32 README runs: the README run (40 days in float32, static
and over 91 daily frames; 90 days in mixed precision and float64,
static and over the frames), two time-varying float64 members over 30
days, and the production seeding in mixed precision and float64 over 30
days (interval_batch 16, no pin), all of its lanes and its first
``EXACT_WINDOW_LANES``. Beside each: the bound (chip_smoke's
``grouped_bound``: inputs and outputs once, this run's attempts and kept
rows' flops); the instance the launcher
takes, each instance's warp occupancy in launch order (a team instance
holds 32 / 8 lanes a warp) and, where the tree has the repacking kernel
(``tracer.EXACT_SCHEDULE``), as its grid would run them and its time
under the schedule "never" (no window ends early); the chain floor (the
longest lane alone, R = 1, in each instance); every instance's rows
bitwise equal; and the registers and spills of every exact kernel in
the build's ``nvcc.log``. ``--schedules`` times the repacked shapes under
each schedule listed too, as with ``--kernels``.

``--rk4`` times the whole-run RK4 kernel alone instead (CUDA events, the
median of ``--runs`` means of 3 launches, each instance in turns: Lane,
Split, Split, Lane) at the shapes of its rows: the default run
(``RunConfig()``: 4,288 lanes, 1,080 steps) and the production seeding
(60,784 lanes, 360 steps), each in float32, float64 and mixed precision;
the default run over 91 daily frames in the three; two time-varying
members (8,864 lanes, 360 steps); and for the team's window the
production seeding's first ``RK4_WINDOW_LANES`` lanes in the three and
the members' first two of those counts. Beside
each: the bound (chip_smoke's ``rk4_bound``), the instance the launcher
takes, every instance's rows bitwise equal, and the chain floor (the lane
alive longest alone, R = 1, in each instance); then the registers and
spills of every RK4 kernel in the build's ``nvcc.log``. ``--variants``
also builds the tree's RK4 units with one part of a step taken out
(``RK4_VARIANTS``: no (ug, vg) sample, no row stores but the last step's;
measurement builds, in a temporary directory, never part of the package)
and times each shape and its lone lane in both instances under them.

``--others`` times the other kernels that share ``csrc/ray_rhs.cuh``'s
sample instead, so that an edit there can be held to a parent tree in
turns (CUDA events, the median of ``--runs`` means of 3 launches, unless
named): the whole-run dense kernel at ``--kernels``' shapes; the entry
stage (``tracer.entry_stage``) on the production seeding's entry lanes
in float32, float64 and mixed precision, and the RHS kernel (``ray.rhs``,
``ray.rhs_and_gv``) in float32 and float64, each the kernel's mean
device time by torch.profiler and its wrapper's by CUDA events (means of
50 calls); the interval kernel
(``rk45._integrate_interval_cuda``) from those lanes at t = 0 to
``OTHERS_INTERVAL_DAYS`` days, at ``OTHERS_INTERVAL_LANES`` lanes, each
instance in turns (Lane, Split, Split, Lane), every instance's state and
trips equal. Beside each a digest of its outputs, equal between trees
that give the same bits. ``--only REGEX`` keeps the rows whose
"kernel shape" it matches.

``--spectral`` times the spectral sampler instead, in every operand case
of chip_smoke's spectral phase (``SPECTRAL_CASES``) on the climatology's
fit at the production run's day-10 positions (as chip_smoke's main_path
takes them): the kernel alone on packed coefficients and the wrapper
(``sample_spectral_cuda``, the packing included), CUDA events, the
median of ``--runs`` means of 3 calls each, and the packing alone
(``pack_on_card`` where the tree has it, else ``pack_coeffs``); beside
each the dtype of the case's packed tiles (which names its MMA) and a
digest of the output. ``--only REGEX`` keeps the cases
whose name it matches.

``--flux`` times the flux binning alone instead (``flux._accumulate_cuda``,
and the region pass before it, ``flux._region_cuda``; CUDA events, the
median of ``--runs`` means of 3 calls each) on chip_smoke's
production-size trajectory (its cli phase's run: 100,800 rays x 361 rows)
with chip_smoke's Fun2 box and mwn cap, and prints the kept rays, the
binned points and the count map's checksum, so that two trees can be seen
to bin the same points.

``--tree DIR`` imports ``rwrt_tpu_torch`` from the checkout DIR (another
commit, unpacked there) to time two trees in turns, one process each
(for example parent, change, change, parent). Imports no JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np

import chip_smoke as cs

#: The whole-run kernel of each path, by the name the profiler shows.
KERNEL = {"dense": "dense_kernel", "rk4": "rk4_kernel",
          "exact": "exact_kernel", "readme": "exact_kernel"}


def lane_iterations(lane_att):
    """Each lane's loop iterations in the whole-run dense kernel, from a
    run's (n_groups, R) step attempts: its trips over all groups, plus
    one iteration to open each group and one to close the last."""
    att = np.asarray(lane_att.cpu() if hasattr(lane_att, "cpu")
                     else lane_att, dtype=np.int64)
    return att.sum(axis=0) + att.shape[0] + 1


def warp_occupancy(lane_att, warp=32):
    """The share of the issued lane-slots that carry a live lane when one
    thread runs each lane to its end, lanes in launch order: lane
    iterations / (warp x the sum over warps of the warp's most), a ragged
    last warp counted at its full width."""
    it = lane_iterations(lane_att)
    slots = np.zeros(-(-it.size // warp) * warp, dtype=np.int64)
    slots[:it.size] = it
    return float(it.sum() / (warp * slots.reshape(-1, warp).max(axis=1).sum()))


def repacked_occupancy(lane_att, block, blocks, every, trigger=None,
                       warp=32):
    """The same share under the repacking kernel's schedule
    (csrc/dense_run.cu): ``blocks`` blocks of ``block`` threads (at most
    one a lane) deal the lanes, each block runs windows of ``every``
    iterations of each live lane, each ended early at the iteration in
    which its ``trigger``-th lane leaves, then moves its live lanes to its
    lowest threads in order and refills its free threads from the queue,
    block by block. Returns (occupancy, issued warp-iterations of each
    block). The block's warps are taken to keep in step within a window,
    and with a queue the blocks to finish their windows together, which
    the card does not promise."""
    it = lane_iterations(lane_att)
    r = it.size
    blocks = min(blocks, r)
    deal = r <= blocks * block
    rem = np.zeros((blocks, block), dtype=np.int64)
    for b in range(blocks):
        lo, hi = ((b * r // blocks, (b + 1) * r // blocks) if deal
                  else (b * block, (b + 1) * block))
        rem[b, :hi - lo] = it[lo:hi]
    nxt = r if deal else blocks * block
    issued = np.zeros(blocks, dtype=np.int64)
    while True:
        window = np.full(blocks, every, dtype=np.int64)
        if trigger is not None and trigger <= block:
            left = np.partition(np.where(rem > 0, rem, np.iinfo(np.int64).max),
                                trigger - 1, axis=1)[:, trigger - 1]
            window = np.minimum(window, left)
        ran = np.minimum(rem, window[:, None])
        issued += ran.reshape(blocks, -1, warp).max(axis=2).sum(axis=1)
        rem -= ran
        live = rem > 0
        rem = np.take_along_axis(rem, np.argsort(~live, axis=1,
                                                 kind="stable"), axis=1)
        n_live = live.sum(axis=1)
        for b in range(blocks):
            take = min(block - n_live[b], r - nxt)
            if take > 0:
                rem[b, n_live[b]:n_live[b] + take] = it[nxt:nxt + take]
                nxt += take
        if not rem.any():
            return float(it.sum() / (warp * issued.sum())), issued


def config(rt, path):
    if path == "dense":
        return cs.production_config(rt)
    if path == "rk4":
        return cs.rk4_production_config(rt)
    if path == "readme":
        return cs.readme_config(rt, 90)
    return cs.production_config(rt, bound_mode="exact", pin_limit=None,
                                interval_batch=16)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--path", choices=sorted(KERNEL), default="dense")
    ap.add_argument("--state-dtype", choices=("compute", "float64"),
                    default="compute")
    ap.add_argument("--warmup", type=int, default=1)
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--out", type=Path, default=Path("profile_out"))
    ap.add_argument("--tree", type=Path, default=None)
    ap.add_argument("--kernels", action="store_true")
    ap.add_argument("--schedules", default="")
    ap.add_argument("--exact", action="store_true")
    ap.add_argument("--only", default="")
    ap.add_argument("--flux", action="store_true")
    ap.add_argument("--rk4", action="store_true")
    ap.add_argument("--variants", default="")
    ap.add_argument("--others", action="store_true")
    ap.add_argument("--spectral", action="store_true")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("profile_main_path: no CUDA device", file=sys.stderr)
        return 1
    if args.tree is not None:
        sys.path.insert(0, str(args.tree.resolve()))
    import rwrt_tpu_torch as rt

    if args.kernels:
        return dense_kernels(torch, rt, args)
    if args.exact:
        return exact_kernels(torch, rt, args)
    if args.flux:
        return flux_binning(torch, rt, args)
    if args.rk4:
        return rk4_kernels(torch, rt, args)
    if args.others:
        return other_kernels(torch, rt, args)
    if args.spectral:
        return spectral_cases(torch, rt, args)
    from rwrt_tpu_torch.tracer import MaxItersTruncation

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    run = cs.Run(torch, rt)
    cfg = dataclasses.replace(config(rt, args.path),
                              state_dtype=args.state_dtype)
    print(f"path {args.path}: {cfg}")
    bs = run.bs(torch.float32)

    stats = {}
    truncated = []
    last = []

    def trace():
        sources = ({} if args.path == "readme"
                   else dict(source_lon=run.slon, source_lat=run.slat))
        last.clear()
        try:
            last.append(rt.trace_rays(bs, cfg, stats=stats, **sources))
        except MaxItersTruncation as e:
            truncated.append(str(e))

    firsts = [cs.wall_s(trace)[1] for _ in range(args.warmup)]
    walls = [cs.wall_s(trace)[1] for _ in range(args.runs)]
    print(f"wall s: warm-up {firsts}, then {walls}" + (
        f", median {statistics.median(walls):.6f}" if walls else ""))

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall = cs.wall_s(trace)
    print(f"profiled run: wall {wall:.6f} s; peak device memory MiB over all "
          f"runs {torch.cuda.max_memory_allocated() / 2 ** 20:.1f}")
    if "lane_att" in stats:
        lane_att = stats["lane_att"]
        print("groups (max trips, step attempts):", list(zip(
            lane_att.amax(dim=1).tolist(), lane_att.sum(dim=1).tolist())))
        print(f"step attempts {int(lane_att.sum())}, longest lane "
              f"{int(lane_att.sum(dim=0).max())} trips over all groups")
    print(f"runs refused by MaxItersTruncation: {len(truncated)}"
          + (f" ({truncated[0]})" if truncated else ""))
    if last:
        # The rows' bytes, so that two trees' runs can be seen to be equal.
        digest = hashlib.sha256()
        for a in last[0]:
            digest.update(a.cpu().numpy().tobytes())
        print(f"rows sha256 (lon, lat, kx, ky, amp, ug, vg): "
              f"{digest.hexdigest()}")

    # The program's spans (``rwrt.*``) are host ranges; should the profiler
    # lay a copy of one on the device's timeline, it is no device work.
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and not e.name.startswith("rwrt.")]
    span = (max(e.time_range.end for e in dev)
            - min(e.time_range.start for e in dev))
    busy = sum(e.time_range.elapsed_us() for e in dev)
    whole = [e for e in dev if KERNEL[args.path] in e.name]
    print(f"profiled run: device span {span:.1f} us, kernel-busy "
          f"{busy:.1f} us, idle share {1 - busy / span:.4f}, "
          f"{len(dev)} device events; {KERNEL[args.path]} launches "
          f"{len(whole)}, "
          f"{sum(e.time_range.elapsed_us() for e in whole):.1f} us")
    if whole:
        # The set-up: the device's work before the whole-run kernel.
        first = min(e.time_range.start for e in dev)
        start = min(e.time_range.start for e in whole)
        before = [e for e in dev if e.time_range.start < start]
        def launches(kernel):
            return sum(kernel in e.name for e in before)

        print(f"profiled run: set-up span (first device event to the "
              f"whole-run kernel's start) {start - first:.1f} us, "
              f"{len(before)} device events in it, kernel-busy "
              f"{sum(e.time_range.elapsed_us() for e in before):.1f} us; "
              f"entry-stage launches {launches('entry_kernel')}, RHS "
              f"launches {launches('rhs_kernel')}")
    key = ("self_device_time_total" if hasattr(
        prof.key_averages()[0], "self_device_time_total")
        else "self_cuda_time_total")
    table = prof.key_averages().table(sort_by=key, row_limit=60)
    args.out.mkdir(parents=True, exist_ok=True)
    tag = args.path + ("_float64" if args.state_dtype == "float64" else "")
    (args.out / f"profile_main_path_{tag}.txt").write_text(table)
    print("\n".join(prof.key_averages().table(
        sort_by=key, row_limit=12).splitlines()[:16]))
    return 0


def dense_call(args, kw, **private):
    """``tracer._dense_run_cuda`` on a unit call's (args, kwargs), as
    ``tracer._dense_run`` passes them, with ``private`` arguments."""
    from rwrt_tpu_torch import tracer

    full = dict(max_iters=1_000_000, pin_limit=None, pin_mwn=None, t0=None)
    full.update(zip(("max_iters", "pin_limit", "pin_mwn", "t0"), args[12:]))
    full.update(kw)
    return tracer._dense_run_cuda(*args[:12], **full, **private)


def median_ms(fn, runs):
    return statistics.median(cs.cuda_ms(fn, 3) for _ in range(runs))


def dense_shapes(torch, rt, run):
    """The whole-run dense kernel's entry (args, kwargs) at each shape."""
    shapes = {}
    _, a, kw, _ = run.run_inputs(torch.float32)
    shapes["production float32"] = (a, kw)
    _, a, kw, _ = run.run_inputs(torch.float32, state=torch.float64)
    shapes["production mixed"] = (a, kw)
    _, a, kw, _ = run.run_inputs(torch.float64)
    shapes["production float64, first N_SUBSET lanes"] = (
        cs.lane_subset(a, cs.N_SUBSET), kw)
    shapes["production float64"] = (a, kw)
    cfg = cs.production_config(rt)
    src = dict(source_lon=run.slon, source_lat=run.slat)
    for name, bs, c in (
            ("time, 31 frames", cs.tv_state(run, cs.TV_DAYS + 1), cfg),
            ("time mixed, 31 frames", cs.tv_state(run, cs.TV_DAYS + 1),
             cs.mixed(cfg)),
            ("time float64, 31 frames",
             cs.tv_state(run, cs.TV_DAYS + 1, torch.float64),
             cs.in_float64(cfg))):
        with cs.captured(run, "_dense_run") as cap:
            # One launch: the card holds the float64 history that passes
            # trace_rays' reroute estimate.
            rt.trace_rays(bs, c, auto_chunk_bytes=None, **src)
        shapes[name] = cap.calls[0][:2]
    years = [rt.prepare(u[0], v[0], lat, lon, device=run.dev)
             for u, v, lat, lon in (cs.climatology_frames(1, sc, ph) for sc, ph
                                    in zip(cs.MEMBER_SCALES,
                                           cs.MEMBER_PHASES))]
    with cs.captured(run, "_dense_run") as cap:
        rt.trace_rays_ensemble(years, cfg, **src)
    shapes["ensemble, 4 members"] = cap.calls[0][:2]
    return shapes


def dense_kernels(torch, rt, args):
    """``--kernels``: see the head of this file."""
    from rwrt_tpu_torch import tracer
    from rwrt_tpu_torch.utils import checkpoint

    run = cs.Run(torch, rt)
    grid = getattr(tracer, "dense_grid", None)
    print(f"tree {rt.__file__}; repacking kernel: {grid is not None}")
    rows = []
    for name, (a, kw) in dense_shapes(torch, rt, run).items():
        if not re.search(args.only, name):
            continue
        out = tracer._dense_run(*a, **kw)
        ms = median_ms(lambda: tracer._dense_run(*a, **kw), args.runs)
        rec = dict(shape=name, lanes=a[1].shape[1], ms=ms,
                   attempts=int(out.lane_att.sum()),
                   longest=int(out.lane_att.sum(dim=0).max()),
                   occupancy=warp_occupancy(out.lane_att))
        if grid is not None:
            from rwrt_tpu_torch import kernels
            from rwrt_tpu_torch.models import ray

            key = kernels.state_key(a[1], a[0].fields)
            variant = ray.kernel_background(a[0], a[1].device, key[1],
                                            a[1].shape[1])[0]
            blocks, block = grid(key, variant)
            occ, issued = repacked_occupancy(
                out.lane_att, block, blocks, *tracer.DENSE_SCHEDULE[key])
            rec.update(grid=[blocks, block], repacked_occupancy=occ,
                       busiest_block=int(issued.max()),
                       mean_block=float(issued.mean()))
            for sched in [x for x in args.schedules.split(",") if x]:
                every, trigger = (int(v) for v in sched.split(":"))
                rec[f"ms_{every}_{trigger}"] = median_ms(
                    lambda: dense_call(a, kw, _repack=every,
                                       _trigger=trigger or 1 << 30),
                    args.runs)
                rec[f"occupancy_{every}_{trigger}"] = repacked_occupancy(
                    out.lane_att, block, blocks, every, trigger or None)[0]
        if name in ("production float32", "production mixed"):
            trips = out.lane_att.sum(dim=0)
            for tag, take in (
                    ("sorted", torch.argsort(trips, descending=True)),
                    ("top1pc", torch.argsort(trips, descending=True)[
                        :max(trips.numel() // 100, 1)])):
                sub = cs.lane_pick(a, take)
                rec[f"{tag}_ms"] = median_ms(
                    lambda: tracer._dense_run(*sub, **kw), args.runs)
                rec[f"{tag}_occupancy"] = warp_occupancy(
                    out.lane_att.index_select(1, take))
        if name == "production float32":
            lane = int(out.lane_att.sum(dim=0).argmax())
            r = a[1].shape[1]
            one = tuple(x[..., lane:lane + 1].contiguous()
                        if hasattr(x, "shape") and x.ndim
                        and x.shape[-1] == r else x for x in a)
            alone = tracer._dense_run(*one, **kw)
            trips = int(alone.lane_att.sum())
            lone_ms = median_ms(lambda: tracer._dense_run(*one, **kw),
                                args.runs)
            rec.update(lone_lane=lane, lone_trips=trips, lone_ms=lone_ms,
                       us_per_trip=lone_ms * 1e3 / trips,
                       chain_floor_ms=lone_ms * rec["longest"] / trips)
        print(json.dumps(rec), flush=True)
        rows.append(rec)
        del out
    cfg = cs.production_config(rt)
    src = dict(source_lon=run.slon, source_lat=run.slat, verbose=False)
    bs = run.bs(torch.float32)
    for name, days, steps in (("6 chunks", cs.N_DAYS, cs.CHUNK_STEPS),
                              ("17 chunks", cs.LONG_DAYS,
                               cs.DEFAULT_CHUNK_STEPS)):
        if not re.search(args.only, name):
            continue
        c = dataclasses.replace(cfg, ttotal=days * cs.DAY)
        sums = []
        for _ in range(max(args.runs // 2, 1)):
            stats = {}
            checkpoint.trace_rays_chunked(bs, c, chunk_steps=steps,
                                          stats=stats, **src)
            sums.append(sum(stats["chunk_ms"]))
        rec = dict(shape=name, ms=statistics.median(sums),
                   chunk_ms=[round(x, 3) for x in stats["chunk_ms"]])
        print(json.dumps(rec), flush=True)
        rows.append(rec)
    args.out.mkdir(parents=True, exist_ok=True)
    tag = "change" if grid is not None else "parent"
    with open(args.out / f"dense_kernels_{tag}.jsonl", "a") as fh:
        for rec in rows:
            fh.write(json.dumps(rec) + "\n")
    return 0


def exact_call(args, kw, **private):
    """``tracer._exact_run_cuda`` on a unit call's (args, kwargs), as
    ``tracer._exact_run`` passes them, with ``private`` arguments."""
    from rwrt_tpu_torch import tracer

    full = dict(max_iters=1_000_000, barrier=False, t0=None)
    full.update(zip(("max_iters", "barrier", "t0"), args[12:]))
    full.update(kw)
    return tracer._exact_run_cuda(*args[:12], **full, **private)


#: Lane counts (the production seeding's first lanes) at which ``--exact``
#: times the instances in mixed precision and float64, for the team's
#: window.
EXACT_WINDOW_LANES = (8192, 16384, 32768)


def exact_shapes(torch, rt, run):
    """The whole-run exact kernel's entry (args, kwargs) at each shape,
    captured from its run through ``trace_rays`` (or
    ``trace_rays_ensemble``)."""
    from rwrt_tpu_torch.tracer import MaxItersTruncation

    f32, f64 = torch.float32, torch.float64
    readme = cs.readme_config(rt)
    readme90 = cs.readme_config(rt, cs.LONG_DAYS)
    tv32 = cs.tv_state(run, cs.LONG_DAYS + 1)
    tv64 = cs.tv_state(run, cs.LONG_DAYS + 1, f64)
    members = [cs.tv_state(run, cs.TV_DAYS + 1, f64, sc, ph)
               for sc, ph in zip(cs.MEMBER_SCALES[:2], cs.MEMBER_PHASES[:2])]
    prod = cs.mixed(cs.production_config(rt, bound_mode="exact",
                                         pin_limit=None, interval_batch=16))
    src = dict(source_lon=run.slon, source_lat=run.slat)
    cases = (
        ("readme float32, 40 d", rt.trace_rays, run.bs(f32), readme, {}),
        ("readme time float32, 40 d, 91 frames", rt.trace_rays, tv32, readme,
         {}),
        ("readme mixed, 90 d", rt.trace_rays, run.bs(f32),
         cs.mixed(readme90), {}),
        ("readme float64, 90 d", rt.trace_rays, run.bs(f64),
         cs.in_float64(readme90), {}),
        ("readme time mixed, 90 d, 91 frames", rt.trace_rays, tv32,
         cs.mixed(readme90), {}),
        ("readme time float64, 90 d, 91 frames", rt.trace_rays, tv64,
         cs.in_float64(readme90), {}),
        ("2 time-varying members float64, 30 d", rt.trace_rays_ensemble,
         members, cs.readme_config(rt, cs.TV_DAYS), None),
        ("production mixed, 30 d", rt.trace_rays, run.bs(f32), prod, src),
        ("production float64, 30 d", rt.trace_rays, run.bs(f64),
         cs.in_float64(prod), src))
    shapes = {}
    for name, driver, bs, cfg, kw in cases:
        with cs.captured(run, "_exact_run") as cap:
            try:
                # One launch: no reroute to the chunked driver.
                driver(bs, cfg, **({} if kw is None else
                                   dict(auto_chunk_bytes=None, **kw)))
            except MaxItersTruncation:
                pass
        shapes[name] = cap.calls[0][:2]
        if name.startswith("production"):
            # The team's window: the seeding's first lanes.
            a, kw = shapes[name]
            for n in EXACT_WINDOW_LANES:
                shapes[f"{name}, first {n} lanes"] = (cs.lane_subset(a, n),
                                                      kw)
    return shapes


def exact_kernels(torch, rt, args):
    """``--exact``: see the head of this file."""
    from rwrt_tpu_torch import kernels, tracer
    from rwrt_tpu_torch.models import ray
    from rwrt_tpu_torch.solvers import rk45

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    run = cs.Run(torch, rt)
    schedule = getattr(tracer, "EXACT_SCHEDULE", None)
    print(f"tree {rt.__file__}; repacking exact kernel: "
          f"{schedule is not None}")
    shapes = {name: call for name, call in exact_shapes(torch, rt,
                                                        run).items()
              if re.search(args.only, name)}
    regs = cs.registers("exact")
    print(json.dumps({"registers": {n: list(r) for n, r in regs.items()}}),
          flush=True)
    turns = ("lane", "split8", "split8", "lane")
    threads = cs.INSTANCE_THREADS
    rows = []
    for name, (a, kw) in shapes.items():
        key = kernels.state_key(a[1], a[0].fields)
        r = a[1].shape[1]
        variant = ray.kernel_background(a[0], a[1].device, key[1], r)[0]
        out = tracer._exact_run(*a, **kw)
        lane_att = out.lane_att
        trips = lane_att.sum(dim=0)
        f32 = key[0] == torch.float32
        flops = ({"float32": cs.EXACT_ATTEMPT_FLOPS} if f32
                 else cs.MIX_EXACT_ATTEMPT_FLOPS if key[1] == torch.float32
                 else {"float64": cs.EXACT_ATTEMPT_FLOPS})
        unit = "float32" if f32 else "float64"
        b, _ = cs.grouped_bound(a, out, flops, {unit: cs.KILL_FLOPS}, False)
        rec = dict(shape=name, lanes=r, attempts=int(lane_att.sum()),
                   longest=int(trips.max()),
                   launcher=rk45.exact_instance(r, key, variant=variant),
                   **b)
        ms = {inst: [] for inst in threads}
        for inst in turns:
            got = exact_call(a, kw, instance=inst)
            for n in ("ys", "ugs", "vgs", "lane_att", "trunc"):
                cs.check(cs.same(getattr(got, n), getattr(out, n)),
                         f"{name}: instance {inst} differs ({n})")
            ms[inst].append(median_ms(lambda: exact_call(a, kw,
                                                         instance=inst),
                                      args.runs))
        for inst, k in threads.items():
            rec[f"{inst}_ms"] = ms[inst]
            rec[f"{inst}_occupancy"] = warp_occupancy(lane_att, 32 // k)
        if schedule is not None and schedule[key] is not None:
            blocks, block = tracer.exact_grid(key, variant, rec["launcher"])
            every, trigger = schedule[key]
            k = threads[rec["launcher"]]
            occ, issued = repacked_occupancy(lane_att, block // k, blocks,
                                             every, trigger, 32 // k)
            rec.update(grid=[blocks, block], schedule=[every, trigger],
                       repacked_occupancy=occ,
                       busiest_block=int(issued.max()),
                       mean_block=float(issued.mean()))
            rec["never_ms"] = median_ms(
                lambda: exact_call(a, kw, _repack=1 << 30,
                                   _trigger=1 << 30), args.runs)
            for sched in [x for x in args.schedules.split(",") if x]:
                e, t = (int(v) for v in sched.split(":"))
                rec[f"ms_{e}_{t}"] = median_ms(
                    lambda: exact_call(a, kw, _repack=e,
                                       _trigger=t or 1 << 30), args.runs)
                rec[f"occupancy_{e}_{t}"] = repacked_occupancy(
                    lane_att, block // k, blocks, e, t or None, 32 // k)[0]
        lane = int(trips.argmax())
        one = cs.lane_pick(a, torch.tensor([lane], device=a[1].device))
        for inst in turns:
            alone = exact_call(one, kw, instance=inst)
            cs.check(cs.same(alone.ys, out.ys[..., lane:lane + 1]),
                     f"{name}: the longest lane alone differs")
            rec.setdefault(f"lone_{inst}_ms", []).append(median_ms(
                lambda: exact_call(one, kw, instance=inst), 1))
        rec["chain_floor_ms"] = min(min(rec[f"lone_{i}_ms"]) for i in threads)
        print(json.dumps(rec), flush=True)
        rows.append(rec)
        del out
    args.out.mkdir(parents=True, exist_ok=True)
    tag = "change" if schedule is not None else "parent"
    with open(args.out / f"exact_kernels_{tag}.jsonl", "a") as fh:
        for rec in rows:
            fh.write(json.dumps(rec) + "\n")
    return 0


#: Lane counts (the production seeding's first lanes) at which ``--rk4``
#: times the instances in each precision, for the team's window.
RK4_WINDOW_LANES = (2048, 6144, 8192, 16384, 32768)
#: ``--variants``: measurement builds of the RK4 kernel, each the tree's
#: ``csrc/rk4_run.cu`` (or the file a substitution names first) with
#: (pattern, replacement) substitutions, each made wherever its pattern
#: occurs; each variant lists its substitutions for each text of the
#: kernel it was measured on (this tree's, and the parent's, 251db8e, for
#: PERF.md's parent columns), the first whose every pattern occurs taken;
#: a text that none fits is refused. ``no_gv``: a row's (ug, vg) are its
#: kx and ky, no sample (the last row's is kept); ``no_rows``: a launch
#: stores only its last rows; ``no_trig``: the evaluation's sin and cos of
#: the latitude replaced by a multiply-add; ``no_div``: every division of
#: an evaluation a multiplication. Their values differ from the kernel's:
#: they only time what a part of the step costs.
_RHS = "ray_rhs.cuh"
RK4_VARIANTS = {
    "no_gv": (
        ((r"rwrt::ray_rhs<F, I>\(bg, ys, t_a, k1, &m1, &ug, &vg\);",
          "rwrt::ray_rhs<F, I>(bg, ys, t_a, k1, &m1); ug = yl[2]; "
          "vg = yl[3];"),
         (r"rwrt::group_velocity_at<S, F, I>\(bg, yl, t_gv, &ug, &vg\);",
          "ug = yl[2]; vg = yl[3];"),
         (r"rwrt::group_velocity_at<S, F, I>\(bg, yn, t_end, &ug, &vg\);",
          "ug = yn[2]; vg = yn[3];")),
        ((r"rwrt::group_velocity_at<S, F, I>\(bg, yn, t_end, &ug, &vg\);",
          "ug = yn[2]; vg = yn[3];"),)),
    "no_rows": (
        ((r"if \(s > 0\) store\(a\.row_offset \+ s - 1, yl, ug, vg\);",
          "if (s > 0 && s + 1 == a.n_steps) "
          "store(a.row_offset + s - 1, yl, ug, vg);"),
         (r"store\(a\.row_offset \+ s, yn, ug, vg\);",
          "if (s + 1 == a.n_steps) store(a.row_offset + s, yn, ug, vg);")),
        ((r"store\(a\.row_offset \+ s, yn, ug, vg\);",
          "if (s + 1 == a.n_steps) store(a.row_offset + s, yn, ug, vg);"),)),
    "no_trig": (
        ((_RHS, r"sincos\(lat, &sin_phi, &cos_phi\);",
          "sin_phi = lat; cos_phi = T(1) - lat * lat;"),),),
    "no_div": (
        ((_RHS, r"q\[j\] = num\[j\] / den\[j\];",
          "q[j] = num[j] * den[j];"),
         (_RHS, r"const T mine = n / d;", "const T mine = n * d;"),
         (_RHS, r"two_pi\) / T\(bg\.dx\)", "two_pi) * T(bg.dx)"),
         (_RHS, r"\(lat - T\(bg\.lat0\)\) / T\(bg\.dy\)",
          "(lat - T(bg.lat0)) * T(bg.dy)"),
         (_RHS, r"tan_phi = sin_phi / cosm;", "tan_phi = sin_phi * cosm;"),
         (_RHS, r"kap = ky_q / kx_q;", "kap = ky_q * kx_q;"),
         (_RHS, r"g\.kap = mwn / zwn;", "g.kap = mwn * zwn;")),
        ((_RHS, r"q\[j\] = num\[j\] / den\[j\];",
          "q[j] = num[j] * den[j];"),
         (_RHS, r"const T mine = n / d;", "const T mine = n * d;"),
         (_RHS, r"tan_phi = sin_phi / cosm;", "tan_phi = sin_phi * cosm;"))),
}


def rk4_variant_library(tree, name):
    """The RK4 units of ``tree`` (a checkout's ``rwrt_tpu_torch``) built
    with ``RK4_VARIANTS[name]`` applied, and the RHS unit for the error
    strings, into a library in a temporary directory; returns (the ctypes
    library with the RK4 entry points' signatures set, registers and spills
    of its kernels as ``chip_smoke.registers`` gives them)."""
    import ctypes
    import shutil
    import tempfile

    from rwrt_tpu_torch.kernels import build

    tmp = Path(tempfile.mkdtemp(prefix=f"rk4_{name}_"))
    shutil.copytree(Path(tree) / "csrc", tmp / "csrc")
    texts = {}
    for subs in RK4_VARIANTS[name]:
        subs = [s if len(s) == 3 else ("rk4_run.cu",) + s for s in subs]
        for f, _, _ in subs:
            texts.setdefault(f, (tmp / "csrc" / f).read_text())
        if all(re.search(pattern, texts[f]) for f, pattern, _ in subs):
            for f, pattern, repl in subs:
                texts[f] = re.sub(pattern, repl, texts[f])
            break
    else:
        raise RuntimeError(f"variant {name}: no form of its substitutions "
                           "matches this tree's sources")
    for f, text in texts.items():
        (tmp / "csrc" / f).write_text(text)
    nvcc = build.find_nvcc()
    units = sorted((tmp / "csrc").glob("rk4_run*.cu")) + [
        tmp / "csrc" / "rhs.cu"]
    jobs = [(u, subprocess.Popen(
        [nvcc, *build.NVCC_FLAGS, "-c", "-o", str(u.with_suffix(".o")),
         str(u)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)) for u in units]
    log = "\n".join(proc.communicate()[0] for _, proc in jobs)
    if any(proc.returncode for _, proc in jobs):
        raise RuntimeError(f"variant {name}: nvcc failed\n{log}")
    lib_path = tmp / build.LIB_NAME
    subprocess.run([nvcc, *build.ARCH, "-shared", "-o", str(lib_path),
                    *(str(u.with_suffix(".o")) for u in units)], check=True)
    lib = ctypes.CDLL(str(lib_path))
    for suffix in ("_f32", "_f64", "_mix"):
        for fn_name, sig in build.SIGNATURES.items():
            if fn_name.startswith("rwrt_rk4") and hasattr(
                    lib, fn_name + suffix):
                fn = getattr(lib, fn_name + suffix)
                fn.argtypes, fn.restype = list(sig), ctypes.c_int
    lib.rwrt_error_string.argtypes = [ctypes.c_int]
    lib.rwrt_error_string.restype = ctypes.c_char_p
    return lib, cs.registers("rk4", log)


def rk4_shapes(torch, rt, run):
    """The whole-run RK4 kernel's arguments (bg, y0, ug0, vg0, dt, nt,
    cut_off) at each shape, with the dtype key ``rk4_bound`` takes."""
    from rwrt_tpu_torch.solvers import rk45

    f32, f64 = torch.float32, torch.float64
    precisions = (("float32", f32, None), ("float64", f64, None),
                  ("mixed", f32, f64))
    shapes = {}
    for name, cfg in (("default", cs.default_config(rt)),
                      ("production", cs.rk4_production_config(rt))):
        for tag, dtype, state in precisions:
            bg, y0, ug0, vg0, _ = run.entry(
                dtype, cfg if name == "default" else None, state)
            sdt = state or dtype
            a = (bg, y0, ug0, vg0, rk45.as_scalar(cfg.tstep, sdt), cfg.nt,
                 rk45.as_scalar(cfg.cut_off_rad, sdt))
            shapes[f"{name} {tag}"] = (a, "mixed" if state else dtype)
    cfg = dataclasses.replace(cs.default_config(rt),
                              ttotal=cs.LONG_DAYS * cs.DAY)
    month = dataclasses.replace(cs.default_config(rt),
                                ttotal=cs.TV_DAYS * cs.DAY)
    cases = []
    for (tag, dtype, state), c, m in zip(
            precisions, (cfg, cs.in_float64(cfg), cs.mixed(cfg)),
            (month, cs.in_float64(month), cs.mixed(month))):
        key = "mixed" if state else dtype
        cases.append((f"default time {tag}, 91 frames", rt.trace_rays,
                      cs.tv_state(run, cs.LONG_DAYS + 1, dtype), c,
                      dict(auto_chunk_bytes=None), key, False))
        members = [cs.tv_state(run, cs.TV_DAYS + 1, dtype, sc, ph)
                   for sc, ph in zip(cs.MEMBER_SCALES[:2],
                                     cs.MEMBER_PHASES[:2])]
        cases.append((f"2 time-varying members {tag}, 30 d",
                      rt.trace_rays_ensemble, members, m, {}, key, True))
    for name, driver, bs, c, kw, key, window in cases:
        with cs.captured(run, "_run_rk4") as cap:
            driver(bs, c, **kw)
        shapes[name] = (cap.calls[0][0], key)
        if window:
            # The time instance's window: the members' first lanes.
            for n in RK4_WINDOW_LANES[:2]:
                shapes[f"{name}, first {n} lanes"] = (cs.lane_pick(
                    cap.calls[0][0], torch.arange(n, device=run.dev)), key)
    for tag, _, _ in precisions:
        a, key = shapes[f"production {tag}"]
        for n in RK4_WINDOW_LANES:
            shapes[f"production {tag}, first {n} lanes"] = (
                cs.lane_subset(a, n), key)
    return shapes


def rk4_kernels(torch, rt, args):
    """``--rk4``: see the head of this file."""
    from rwrt_tpu_torch import kernels, tracer
    from rwrt_tpu_torch.models import ray

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    run = cs.Run(torch, rt)
    tree = Path(rt.__file__).parent
    print(f"tree {tree}", flush=True)
    shapes = {name: s for name, s in rk4_shapes(torch, rt, run).items()
              if re.search(args.only, name)}
    regs = cs.registers("rk4")
    print(json.dumps({"registers": {n: list(r) for n, r in regs.items()}}),
          flush=True)
    turns = ("lane", "split8", "split8", "lane")
    rows, lone = [], {}
    for name, (a, dkey) in shapes.items():
        bg, y0 = a[0], a[1]
        key = kernels.state_key(y0, bg.fields)
        r = y0.shape[1]
        variant = ray.kernel_background(bg, y0.device, key[1], r)[0]
        out = tracer._run_rk4(*a)
        b = cs.rk4_bound(bg, y0, a[2], a[3], out, dkey)
        rec = dict(shape=name, lanes=r, steps=a[5] - 1,
                   launcher=tracer.rk4_instance(r, key, variant), **b)
        ms = {inst: [] for inst in cs.INSTANCE_THREADS}
        for inst in turns:
            got = tracer._run_rk4_cuda(*a, inst)
            cs.check(all(cs.same(x, y) for x, y in zip(got, out)),
                     f"{name}: instance {inst} differs")
            ms[inst].append(median_ms(
                lambda: tracer._run_rk4_cuda(*a, inst), args.runs))
        for inst in cs.INSTANCE_THREADS:
            rec[f"{inst}_ms"] = ms[inst]
        # Every lane takes every step; the lane alive longest is the chain.
        lane = int(out[0][:, 0].isfinite().sum(dim=0).argmax())
        one = cs.lane_pick(a, torch.tensor([lane], device=y0.device))
        lone[name] = one
        for inst in turns:
            alone = tracer._run_rk4_cuda(*one, inst)
            cs.check(cs.same(alone[0], out[0][..., lane:lane + 1]),
                     f"{name}: the lane alone differs")
            rec.setdefault(f"lone_{inst}_ms", []).append(median_ms(
                lambda: tracer._run_rk4_cuda(*one, inst), args.runs))
        rec["chain_floor_ms"] = min(min(rec[f"lone_{i}_ms"])
                                    for i in cs.INSTANCE_THREADS)
        rec["us_per_step_floor"] = rec["chain_floor_ms"] * 1e3 / rec["steps"]
        print(json.dumps(rec), flush=True)
        rows.append(rec)
        del out
    for vname in [v for v in args.variants.split(",") if v]:
        lib, vregs = rk4_variant_library(tree, vname)
        print(json.dumps({"variant": vname, "registers": {
            n: list(r) for n, r in vregs.items()}}), flush=True)
        built = kernels.library
        kernels.library = lambda: lib
        try:
            for name, (a, _) in shapes.items():
                rec = dict(variant=vname, shape=name)
                for inst in cs.INSTANCE_THREADS:
                    rec[f"{inst}_ms"] = median_ms(
                        lambda: tracer._run_rk4_cuda(*a, inst), args.runs)
                    rec[f"lone_{inst}_ms"] = median_ms(
                        lambda: tracer._run_rk4_cuda(*lone[name], inst),
                        args.runs)
                print(json.dumps(rec), flush=True)
                rows.append(rec)
        finally:
            kernels.library = built
    args.out.mkdir(parents=True, exist_ok=True)
    with open(args.out / "rk4_kernels.jsonl", "a") as fh:
        for rec in rows:
            fh.write(json.dumps(dict(rec, tree=str(tree))) + "\n")
    return 0


#: ``--others``: the interval kernel's bound (days from the entry) and the
#: lane counts of its launches (the production seeding's first lanes).
OTHERS_INTERVAL_DAYS = 30
OTHERS_INTERVAL_LANES = (2048, 60784)


def digest(*tensors):
    """The first 16 hex digits of the sha256 of the tensors' bytes, so that
    two trees' outputs can be seen to be equal."""
    h = hashlib.sha256()
    for x in tensors:
        h.update(x.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def other_kernels(torch, rt, args):
    """``--others``: see the head of this file."""
    from rwrt_tpu_torch import kernels, tracer
    from rwrt_tpu_torch.models import ray
    from rwrt_tpu_torch.solvers import rk45

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    run = cs.Run(torch, rt)
    print(f"tree {Path(rt.__file__).parent}", flush=True)
    rows = []

    def emit(rec):
        if re.search(args.only, f"{rec['kernel']} {rec['shape']}"):
            print(json.dumps(rec), flush=True)
            rows.append(rec)

    for name, (a, kw) in dense_shapes(torch, rt, run).items():
        if not re.search(args.only, f"dense {name}"):
            continue
        out = tracer._dense_run(*a, **kw)
        emit(dict(kernel="dense", shape=name, lanes=a[1].shape[1],
                  ms=median_ms(lambda: tracer._dense_run(*a, **kw),
                               args.runs),
                  rows=digest(out.ys, out.ugs, out.vgs, out.lane_att)))
        del out
    cfg = cs.production_config(rt)
    for tag, dtype, state in (("float32", torch.float32, None),
                              ("float64", torch.float64, None),
                              ("mixed", torch.float32, torch.float64)):
        bg, y0, _, _, _ = run.entry(dtype, None, state)
        sdt = state or dtype
        r = y0.shape[1]
        tol = (rk45.validate_tol(cfg.rtol, sdt), rk45.as_scalar(cfg.atol, sdt))

        def entry():
            return tracer.entry_stage(bg, y0, 0.0, *tol)

        h0, f0 = entry()
        emit(dict(kernel="entry", shape=f"production {tag}", lanes=r,
                  kernel_us=cs.launch_parts(entry, ["entry_kernel"]).get(
                      "entry_kernel"),
                  wrapper_ms=cs.cuda_ms(entry, 50), rows=digest(h0, f0)))
        if state is not None:
            continue  # the RHS and interval kernels have no mixed instance
        for gv in (False, True):
            def rhs():
                return (ray.rhs_and_gv if gv else ray.rhs)(bg, y0)

            emit(dict(kernel="rhs" + ("_and_gv" if gv else ""),
                      shape=f"production {tag}", lanes=r,
                      kernel_us=cs.launch_parts(rhs, ["rhs_kernel"]).get(
                          "rhs_kernel"),
                      wrapper_ms=cs.cuda_ms(rhs, 50), rows=digest(*rhs())))
        step = rk45.as_scalar(min(cfg.min_step_factor * cfg.tstep,
                                  cfg.tstep * 1e-3), sdt)
        for n in OTHERS_INTERVAL_LANES:
            e = [x[..., :n].contiguous() for x in (
                y0, torch.zeros(r, dtype=sdt, device=run.dev), h0)]

            def interval(inst):
                return rk45._integrate_interval_cuda(
                    bg, *e, OTHERS_INTERVAL_DAYS * cs.DAY, *tol, step,
                    max_iters=10_000, instance=inst)

            out = interval("lane")
            rec = dict(kernel="interval", shape=f"production {tag}, first "
                       f"{n} lanes, {OTHERS_INTERVAL_DAYS} d", lanes=n,
                       launcher=rk45.interval_instance(n, dtype),
                       trips=int(out[5].sum()), rows=digest(out[0], out[5]))
            for inst in ("lane", "split8", "split8", "lane"):
                got = interval(inst)
                cs.check(cs.same(got[0], out[0])
                         and torch.equal(got[5], out[5]),
                         f"interval {n}: instance {inst} differs")
                rec.setdefault(f"{inst}_ms", []).append(median_ms(
                    lambda: interval(inst), args.runs))
            emit(rec)
    args.out.mkdir(parents=True, exist_ok=True)
    with open(args.out / "other_kernels.jsonl", "a") as fh:
        for rec in rows:
            fh.write(json.dumps(dict(rec, tree=rt.__file__)) + "\n")
    return 0


def spectral_cases(torch, rt, args):
    """``--spectral``: see the head of this file."""
    from rwrt_tpu_torch.ops import spectral_sample as spec

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    run = cs.Run(torch, rt)
    print(f"tree {Path(rt.__file__).parent}", flush=True)
    traj = rt.trace_rays(run.bs(torch.float32), cs.production_config(rt),
                         source_lon=run.slon, source_lat=run.slat)
    lon10, lat10 = traj.lon[120].reshape(-1), traj.lat[120].reshape(-1)
    fin = torch.isfinite(lon10) & torch.isfinite(lat10)
    pos = (lon10[fin].contiguous(), lat10[fin].contiguous())
    del traj
    pack = getattr(spec, "pack_on_card", spec.pack_coeffs)
    fits = {}
    rows = []
    for name, mm_name in cs.SPECTRAL_CASES:
        tag = name + ("" if mm_name is None else "_" + mm_name)
        if not re.search(args.only, tag):
            continue
        dtype = getattr(torch, name)
        mm = None if mm_name is None else getattr(torch, mm_name)
        if name not in fits:
            fits[name] = spec.fit_spectral(run.bs(dtype))
        sbg = fits[name]
        lo, la = (x.to(dtype) for x in pos)
        tht = (la - sbg.lat0).contiguous()
        packed = pack(sbg.coeffs, mm)
        out = torch.empty((lo.shape[0], sbg.coeffs.shape[2]), dtype=dtype,
                          device=run.dev)

        def kernel():
            spec.launch_kernel(packed, lo, la, tht, sbg.coeffs.shape, mm,
                               out)

        kernel()
        rec = dict(case=tag, tiles=str(packed.dtype)[6:], lanes=lo.shape[0],
                   kernel_ms=median_ms(kernel, args.runs),
                   wrapper_ms=median_ms(lambda: spec.sample_spectral_cuda(
                       sbg, lo, la, matmul_dtype=mm), args.runs),
                   pack_ms=median_ms(lambda: pack(sbg.coeffs, mm),
                                     args.runs),
                   rows=digest(out))
        print(json.dumps(rec), flush=True)
        rows.append(rec)
    args.out.mkdir(parents=True, exist_ok=True)
    with open(args.out / "spectral_cases.jsonl", "a") as fh:
        for rec in rows:
            fh.write(json.dumps(dict(rec, tree=rt.__file__)) + "\n")
    return 0


def flux_binning(torch, rt, args):
    """``--flux``: see the head of this file."""
    import os
    import tempfile

    from rwrt_tpu_torch.diagnostics import flux

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    run = cs.Run(torch, rt)
    with tempfile.TemporaryDirectory() as tmp:
        u, v, lat, lon = cs.climatology_background()
        js = cs.cli_production_js(
            cs.save_wind(os.path.join(tmp, "uv.npz"), u, v, lat, lon), tmp)
        cfg = cs.json_config(rt, js)
        bs = cs.wind_state(run, js["inputuv"], cfg)
    traj = rt.trace_rays(bs, cfg)
    rows = [flux._rows(getattr(traj, k))
            for k in ("lon", "lat", "amp", "ug", "vg", "ky")]
    zero = torch.zeros(rows[0].shape[1], dtype=torch.bool, device=run.dev)
    keep = flux._region_cuda(*rows[:3], zero, *cs.FLUX_BOX)
    call = (*rows, keep, None, 360, 90,
            flux.Thresholds(mwn_max=cs.FLUX_MWN_MAX), "amp_cg")
    maps, _ = flux._accumulate_cuda(*call)
    ms = median_ms(lambda: flux._accumulate_cuda(*call), args.runs)
    region_ms = median_ms(lambda: flux._region_cuda(*rows[:3], zero,
                                                    *cs.FLUX_BOX), args.runs)
    count = maps[3].to(torch.float64)
    rec = dict(tree=str(Path(rt.__file__).parent.parent), ms=ms,
               region_ms=region_ms,
               rays=rows[0].shape[1], rows=rows[0].shape[0],
               kept=int(keep.sum()), binned=int(count.sum()),
               count_checksum=float((count * torch.arange(
                   count.numel(), device=count.device,
                   dtype=torch.float64).reshape(count.shape)).sum()))
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
