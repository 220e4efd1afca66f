#!/usr/bin/env python3
"""Time and profile the PyTorch/CUDA port's production run on one CUDA card.

    python3 profile_main_path.py [--runs 5] [--out DIR (profile_out)]

Runs chip_smoke.py's production workload (100,800 rays, 30 days, dense
RK45, pin (500, 0), float32) through ``rwrt_tpu_torch.trace_rays``: one
warm-up run, then ``--runs`` timed runs (host wall to a device synchronize),
then one run under ``torch.profiler``. Prints the card (``nvidia-smi`` name
and power limit), each wall, the peak device memory, the device span,
kernel-busy time and kernel count of the profiled run (so the device's
idle share), the whole-run dense kernel's device time, each group's most
trips and step attempts and the longest lane's trips over all groups (from
``trace_rays``' ``stats``), and the profiler's top operators; the full
operator table goes to ``DIR/profile_main_path.txt``. The profiler inflates the host side, so the
profiled run's span is longer than an untraced run's wall. Imports no JAX.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
import time
from pathlib import Path

import chip_smoke as cs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--out", type=Path, default=Path("profile_out"))
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("profile_main_path: no CUDA device", file=sys.stderr)
        return 1
    import rwrt_tpu_torch as rt

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    run = cs.Run(torch, rt)
    cfg = cs.production_config(rt)
    bs = run.bs(torch.float32)

    stats = {}

    def trace():
        return rt.trace_rays(bs, cfg, source_lon=run.slon,
                             source_lat=run.slat, stats=stats)

    _, first = cs.wall_s(trace)
    walls = [cs.wall_s(trace)[1] for _ in range(args.runs)]
    print(f"wall s: first run {first:.6f}, then {walls}, median "
          f"{statistics.median(walls):.6f}")
    print(f"peak device memory MiB "
          f"{torch.cuda.max_memory_allocated() / 2 ** 20:.1f}")

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        trace()
        torch.cuda.synchronize()
    lane_att = stats["lane_att"]
    print("dense groups (max trips, step attempts):", list(zip(
        lane_att.amax(dim=1).tolist(), lane_att.sum(dim=1).tolist())))
    print(f"step attempts {int(lane_att.sum())}, longest lane "
          f"{int(lane_att.sum(dim=0).max())} trips over all groups")

    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    span = (max(e.time_range.end for e in dev)
            - min(e.time_range.start for e in dev))
    busy = sum(e.time_range.elapsed_us() for e in dev)
    dense = [e.time_range.elapsed_us() for e in dev
             if "dense_kernel" in e.name]
    print(f"profiled run: device span {span:.1f} us, kernel-busy "
          f"{busy:.1f} us, idle share {1 - busy / span:.4f}, "
          f"{len(dev)} device events; dense kernel launches {len(dense)}, "
          f"{sum(dense):.1f} us")
    key = ("self_device_time_total" if hasattr(
        prof.key_averages()[0], "self_device_time_total")
        else "self_cuda_time_total")
    table = prof.key_averages().table(sort_by=key, row_limit=60)
    args.out.mkdir(parents=True, exist_ok=True)
    (args.out / "profile_main_path.txt").write_text(table)
    print("\n".join(prof.key_averages().table(
        sort_by=key, row_limit=12).splitlines()[:16]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
