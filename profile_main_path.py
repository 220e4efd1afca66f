#!/usr/bin/env python3
"""Time and profile the PyTorch/CUDA port's production run on one CUDA card.

    python3 profile_main_path.py [--path dense|rk4|exact|readme]
                                 [--state-dtype compute|float64]
                                 [--warmup 1] [--runs 5]
                                 [--out DIR (profile_out)]

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
whole-run kernel's device time, for the adaptive paths each group's most
trips and step attempts and the longest lane's trips over all groups (from
``trace_rays``' ``stats``), whether the run hit the max_iters backstop
(``MaxItersTruncation``: then the run is refused and reported as such),
and the profiler's top operators; the full operator table goes to
``DIR/profile_main_path_<path>.txt`` (``_<path>_float64.txt`` in mixed
precision). The profiler inflates the host side, so the
profiled run's span is longer than an untraced run's wall. Imports no JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import statistics
import subprocess
import sys
from pathlib import Path

import chip_smoke as cs

#: The whole-run kernel of each path, by the name the profiler shows.
KERNEL = {"dense": "dense_kernel", "rk4": "rk4_kernel",
          "exact": "exact_kernel", "readme": "exact_kernel"}


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
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("profile_main_path: no CUDA device", file=sys.stderr)
        return 1
    import rwrt_tpu_torch as rt
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

    def trace():
        sources = ({} if args.path == "readme"
                   else dict(source_lon=run.slon, source_lat=run.slat))
        try:
            rt.trace_rays(bs, cfg, stats=stats, **sources)
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

    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    span = (max(e.time_range.end for e in dev)
            - min(e.time_range.start for e in dev))
    busy = sum(e.time_range.elapsed_us() for e in dev)
    whole = [e.time_range.elapsed_us() for e in dev
             if KERNEL[args.path] in e.name]
    print(f"profiled run: device span {span:.1f} us, kernel-busy "
          f"{busy:.1f} us, idle share {1 - busy / span:.4f}, "
          f"{len(dev)} device events; {KERNEL[args.path]} launches "
          f"{len(whole)}, {sum(whole):.1f} us")
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


if __name__ == "__main__":
    sys.exit(main())
