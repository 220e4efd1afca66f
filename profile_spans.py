#!/usr/bin/env python3
"""The stages of a benchmark cell's requests on one CUDA card: the spans
``trace_rays`` records under ``torch.profiler`` (``rwrt.*``,
``rwrt_tpu_torch/utils/observability.py``) and its host syncs.

    python3 profile_spans.py [--workload rk4_f64.static] [--seed 0]
                             [--requests 20] [--traced 10]
                             [--tree DIR ...] [--out DIR (profile_out)]

For each ``--tree`` in turn (a checkout whose program and ``portbench/``
are run, in a process of its own; default this one; name a tree more than
once to run the trees in turns, for example parent, change, change,
parent), the cell's program is built as ``portbench/run.py`` builds it
(its configuration, traffic and inputs from the seed) and warmed up with
two requests; then ``--requests`` requests run untraced, ``--traced``
under ``torch.profiler``, and one and then ``--requests`` more with
torch's sync debug mode warning at each synchronizing operation inside a
request (the first watched request of a process also sees one sync of
torch's own, so it is not counted). Each
request is timed on the host clock from the call to a synchronize.

Prints the card (name and power limit), then for each tree the untraced
and traced walls (their difference is what the profiler and the spans
cost), and per span name: calls a request, mean wall, the device time of
the work launched inside (``device_time_total``), the CUDA runtime launch
and copy calls inside; the children's share of the roots' wall; the
device's idle time inside the root spans and over the traced window
(first root's start to last root's end), a request; ``tracer.HOST_SYNCS``
a request beside the synchronizing operations torch saw. A tree without
spans or the counter reports what it has. One JSON line a tree goes to
stdout and to ``DIR/profile_spans.jsonl``. Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

#: The program's spans.
PREFIX = "rwrt."
#: The CUDA runtime's launch and copy calls (names start so).
RUNTIME = ("cudaLaunchKernel", "cuLaunchKernel", "cudaMemcpyAsync",
           "cudaMemsetAsync")
#: Host ranges the profiler also lays on the device's timeline.
ANNOTATIONS = (PREFIX, "portbench.")


def is_device(event) -> bool:
    kind = getattr(event, "device_type", None)
    return kind is not None and kind.name in ("CUDA", "PrivateUse1")


def device_us(event) -> float:
    """The device time of the work launched inside a host event."""
    total = getattr(event, "device_time_total", None)
    return float(getattr(event, "cuda_time_total", 0.0)
                 if total is None else total)


def _root_of(event):
    """The outermost program span enclosing ``event`` (itself included),
    and the nearest program span above it (None for a root)."""
    up, nearest, root = event.cpu_parent, None, event
    while up is not None:
        if up.name.startswith(PREFIX):
            nearest = nearest or up
            root = up
        up = up.cpu_parent
    return root, nearest


def busy_union(events):
    """The union of the device operations' intervals, sorted [[s, e]]:
    the device's own work, the profiler's copies of host ranges left out."""
    merged = []
    for s, e in sorted((x.time_range.start, x.time_range.end)
                       for x in events if is_device(x)
                       and not x.name.startswith(ANNOTATIONS)):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _busy_in(merged, a, b) -> float:
    return sum(max(0.0, min(e, b) - max(s, a)) for s, e in merged)


def span_summary(events) -> dict:
    """A trace's program spans, reduced: the requests (root spans), per
    span name its calls, wall, device time and runtime launch and copy
    calls (us, summed over the trace), the wall of the roots and of their
    children, the device's idle time inside the roots and over the window
    from the first root's start to the last root's end, and the copies of
    program spans the profiler laid on the device's timeline (none
    expected: ``span`` records operator ranges)."""
    host = [e for e in events if not is_device(e)]
    spans = [e for e in host if e.name.startswith(PREFIX)]
    calls = [(e.time_range.start, e.time_range.end, e.thread)
             for e in host if e.name.startswith(RUNTIME)]
    merged = busy_union(events)
    by_name, roots, child_us = {}, [], 0.0
    for e in spans:
        a, b = e.time_range.start, e.time_range.end
        row = by_name.setdefault(e.name, {"calls": 0, "wall_us": 0.0,
                                          "device_us": 0.0, "runtime": 0})
        row["calls"] += 1
        row["wall_us"] += b - a
        row["device_us"] += device_us(e)
        row["runtime"] += sum(1 for s, t, th in calls
                              if th == e.thread and a <= s and t <= b)
        root, nearest = _root_of(e)
        if nearest is None:
            roots.append(e)
        elif nearest is root:
            child_us += b - a
    copies = sum(1 for e in events
                 if is_device(e) and e.name.startswith(PREFIX))
    out = {"requests": len(roots), "spans": by_name, "device_copies": copies,
           "root_us": sum(e.time_range.elapsed_us() for e in roots),
           "children_us": child_us}
    if roots:
        out["idle_in_roots_us"] = sum(
            e.time_range.elapsed_us()
            - _busy_in(merged, e.time_range.start, e.time_range.end)
            for e in roots)
        w0 = min(e.time_range.start for e in roots)
        w1 = max(e.time_range.end for e in roots)
        out["window_idle_us"] = (w1 - w0) - _busy_in(merged, w0, w1)
    return out


def _serve(torch, program, device, n, debug=False):
    """``n`` requests, each timed to a synchronize; returns (walls in
    seconds, the synchronizing operations torch warned of inside them, by
    the file and line of the program that made them)."""
    walls, syncs = [], {}
    for _ in range(n):
        t0 = time.perf_counter()
        if debug:
            with warnings.catch_warnings(record=True) as seen:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    out = program.request()
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            for w in seen:
                if "synchroniz" in str(w.message):
                    at = f"{Path(w.filename).name}:{w.lineno}"
                    syncs[at] = syncs.get(at, 0) + 1
        else:
            out = program.request()
        torch.cuda.synchronize(device)
        walls.append(time.perf_counter() - t0)
        del out
    return walls, syncs


def one_tree(args) -> dict:
    """The measurement in this process, over the program of ``args.one``."""
    tree = Path(args.one).resolve()
    sys.path.insert(0, str(tree))
    import torch
    from torch.profiler import ProfilerActivity, profile

    from portbench import spec
    from portbench.inputs import make_inputs
    from portbench.program import Program
    from rwrt_tpu_torch import tracer

    if not torch.cuda.is_available():
        raise SystemExit("profile_spans: no CUDA device")
    device = torch.device("cuda", 0)
    bench = spec.load_benchmark(tree)
    cell = spec.workload(bench, args.workload)
    config = spec.config_file(tree, bench, cell["config"])
    traffic = spec.traffic_file(cell["traffic"], tree / "portbench")
    program = Program(config, traffic,
                      make_inputs(config, traffic, args.seed), device)
    _serve(torch, program, device, 2)
    syncs0 = getattr(tracer, "HOST_SYNCS", None)
    walls, _ = _serve(torch, program, device, args.requests)
    syncs1 = getattr(tracer, "HOST_SYNCS", None)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        traced, _ = _serve(torch, program, device, args.traced)
    summary = span_summary(prof.events())
    del prof
    # The first request watched in a process also sees one sync of
    # torch's own, outside the program.
    _serve(torch, program, device, 1, debug=True)
    _, seen = _serve(torch, program, device, args.requests, debug=True)
    return {
        "tree": str(args.one), "workload": args.workload, "seed": args.seed,
        "torch": torch.__version__,
        "untraced_ms": [w * 1e3 for w in walls],
        "traced_ms": [w * 1e3 for w in traced],
        "host_syncs": (None if syncs0 is None
                       else (syncs1 - syncs0) / args.requests),
        "torch_syncs": sum(seen.values()) / args.requests,
        "torch_syncs_at": seen,
        **summary,
    }


def report(rec: dict) -> None:
    un, tr = rec["untraced_ms"], rec["traced_ms"]
    print(f"tree {rec['tree']} (torch {rec['torch']}): {rec['workload']} "
          f"seed {rec['seed']}; request ms untraced mean "
          f"{statistics.mean(un):.3f} median {statistics.median(un):.3f}, "
          f"traced mean {statistics.mean(tr):.3f} median "
          f"{statistics.median(tr):.3f}; host syncs a request "
          f"{rec['host_syncs']}, synchronizing operations torch saw "
          f"{rec['torch_syncs']} ({rec['torch_syncs_at']})")
    n = rec["requests"]
    if not n:
        print("  no program spans in the trace")
        return
    print(f"  {'span':<26}{'calls/req':>10}{'wall ms':>10}{'device ms':>11}"
          f"{'launches':>10}")
    for name, r in rec["spans"].items():
        print(f"  {name:<26}{r['calls'] / n:>10.2f}"
              f"{r['wall_us'] / 1e3 / n:>10.4f}"
              f"{r['device_us'] / 1e3 / n:>11.4f}{r['runtime'] / n:>10.2f}")
    rest = (rec["root_us"] - rec["children_us"]) / 1e3 / n
    print(f"  children cover {rec['children_us'] / rec['root_us']:.4f} of "
          f"the roots' wall ({rest:.4f} ms a request outside them); device "
          f"idle a request inside the roots "
          f"{rec['idle_in_roots_us'] / 1e3 / n:.4f} ms, over the window "
          f"{rec['window_idle_us'] / 1e3 / n:.4f} ms; copies of the spans "
          f"on the device's timeline {rec['device_copies']}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="rk4_f64.static")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests", type=int, default=20)
    ap.add_argument("--traced", type=int, default=10)
    ap.add_argument("--tree", action="append", default=None)
    ap.add_argument("--out", type=Path, default=Path("profile_out"))
    ap.add_argument("--one", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one is not None:
        print(json.dumps(one_tree(args)), flush=True)
        return 0
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    args.out.mkdir(parents=True, exist_ok=True)
    for tree in args.tree or ["."]:
        done = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--one", tree,
             "--workload", args.workload, "--seed", str(args.seed),
             "--requests", str(args.requests), "--traced",
             str(args.traced)], capture_output=True, text=True)
        if done.returncode:
            print(done.stderr[-4000:], file=sys.stderr)
            return done.returncode
        line = done.stdout.strip().splitlines()[-1]
        with open(args.out / "profile_spans.jsonl", "a") as f:
            f.write(line + "\n")
        report(json.loads(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
