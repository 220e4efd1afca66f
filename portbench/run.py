#!/usr/bin/env python3
"""Run one cell of the port's benchmark once and print its result.

    python3 portbench/run.py --workload CELL --seed N --seconds S --trace 0|1

A cell is an entry of ``BENCHMARK.json`` ``workloads``: a configuration
(``portbench/configs/<config>.json``) under a traffic mix
(``portbench/traffic/<traffic>.json``). The run makes the cell's inputs from
the seed (``inputs.py``), prepares the basic states on the card and warms
up with two requests (the set-up, ``setup_s``: from the start of this
script, the import of torch, the card, the build or load of the kernel
library, preparing and warming up); then it sends back-to-back requests
from one client, each timed on the host clock to a device synchronize, for
``--seconds`` seconds (the window); then it judges the window's results
against the plain reference (``check.py``, ``portbench/reference``) and
prints one JSON line. With ``--trace 1`` the window's ``TRACE_SECONDS`` after its first
``UNTRACED_SECONDS`` run under ``torch.profiler``, and the line holds the
cell's per-layer metrics, each read by ``portbench/metrics/<name>.py``, and
the trace's breakdown; with ``--trace 0`` it holds the cell's end-to-end
metrics.

The run exits with 2 and prints no result where torch sees no CUDA card
(or fewer than the cell asks for), and with 3 where the process holds
``jax``, ``jaxlib``, ``flax`` or ``rwrt_tpu`` once the window has closed.
The port's kernels build into ``rwrt_tpu_torch/_build`` inside the
checkout, so only a checkout's first run compiles.
"""

import time

START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if __name__ == "__main__":
    # Run as a script: import this folder as the package it is, and the
    # program from the checkout's root.
    sys.path[0] = str(ROOT)

import numpy as np  # noqa: E402

from portbench import check, imports, spec, work  # noqa: E402
from portbench.inputs import make_inputs  # noqa: E402
from portbench.trace import REQUEST, WINDOW, summarize, top  # noqa: E402

#: A ``--trace 1`` window's untraced start (seconds, at least one
#: request), for the requests' wall, then its traced part (seconds, at least
#: TRACE_REQUESTS requests), early in the process: the profiler drops
#: records late in a long one.
UNTRACED_SECONDS = 2.0
TRACE_SECONDS = 1.5
TRACE_REQUESTS = 3
#: Requests before the window (set-up).
WARMUP_REQUESTS = 2
#: The program's launch counters (``Program.launches``), each with the
#: names its kernels' launches have on the card.
KERNELS = {"dense_kernel": ("dense_kernel",), "rk4_kernel": ("rk4_kernel",),
           "exact_kernel": ("exact_kernel", "exact_run_kernel"),
           "entry_kernel": ("entry_kernel",)}
#: The whole-run kernels among them.
RUN_KERNELS = ("dense_kernel", "rk4_kernel", "exact_kernel")


def launches_seen(ops, counter):
    """The launches a trace's ``ops`` hold of a counter's kernels."""
    names = KERNELS.get(counter, (counter,))
    return sum(c for k, (c, _) in ops.items() if any(n in k for n in names))


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def device_platform(torch, device):
    if device.type == "cuda":
        return dict(platform="gpu", kind=torch.cuda.get_device_name(device),
                    count=1)
    return dict(platform="cpu", kind="cpu", count=1)


def sync(torch, device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(torch, device, program, sampler, held, seconds, min_requests=1,
          record=False):
    """Back-to-back requests for ``seconds`` (at least ``min_requests``):
    returns (request walls in seconds, failures, the window's start and
    end on the host clock). Each request goes to ``sampler`` after its time
    is taken, and its output is held in ``held[0]`` until the next one
    starts."""
    from torch.profiler import record_function

    walls, failed = [], 0
    t_start = time.perf_counter()
    t_end = t_start
    while (time.perf_counter() - t_start < seconds
           or len(walls) + failed < min_requests):
        held[0] = None
        t0 = time.perf_counter()
        try:
            if record:
                with record_function(REQUEST):
                    out = program.request()
                    sync(torch, device)
            else:
                out = program.request()
                sync(torch, device)
        except Exception as e:  # a failed request counts and the loop goes on
            failed += 1
            log(f"request failed: {type(e).__name__}: {e}")
            continue
        t1 = time.perf_counter()
        walls.append(t1 - t0)
        t_end = t1
        sampler.take(out)
        held[0], out = out, None
    return walls, failed, t_start, t_end


def work_of(torch, program, out) -> work.RunFacts:
    """What one request's whole run did (``work.RunFacts``), from its
    outputs: the integrated lanes are the program's compaction of the
    born ones (row 0's amp finite)."""
    cfg = program.run_config
    nt = cfg.nt
    amp0 = torch.cat([x[0] for x in out.fields[4]])
    idx = work.compact_lane_indices(torch.isfinite(amp0).cpu().numpy())
    if idx is None:
        idx = np.arange(amp0.numel())
    cols = torch.as_tensor(idx, device=amp0.device)
    lon = torch.cat([x[1:] for x in out.fields[0]], dim=1)
    kept = int(torch.isfinite(lon.index_select(1, cols)).sum())
    states = program.states
    fields = states[0].fields
    timed = fields.ndim == 4
    w, h = fields.shape[-3], fields.shape[-2]
    frames = fields.shape[0] if timed else 1
    stack = len(states) * frames * w * h * 48 * fields.element_size()
    wide = cfg.state_dtype == "float64" and len(states) == 1
    ssize = 8 if wide else fields.element_size()
    la = out.lane_att
    return work.RunFacts(
        cfg.integrator, cfg.bound_mode, len(idx), kept, nt,
        0 if la is None else la.shape[0],
        min(cfg.interval_batch, nt - 1) if la is not None else 0,
        0 if la is None else int(la.sum()), ssize, fields.element_size(),
        stack, timed, "float64" if ssize == 8 else "float32")


class Context(SimpleNamespace):
    """What a per-layer metric's reader reads: the trace's summary
    (``trace``), the requests it held, the requests' mean wall (ms,
    ``request_ms``, of the untraced ones before the trace), the program's
    launch counters over the trace (``launches``), the counters whose
    launches the trace lost (``dropped``), the peak device memory
    (``peak_bytes``), what the request's run did (``facts``,
    ``work.RunFacts``) and the least times of its kernels (``bounds``,
    ``work.Bound`` by kernel)."""

    def kernel_ms(self, counter):
        """Mean device ms of one launch of a counter's kernels (``KERNELS``);
        None where the trace holds none or lost some."""
        names = KERNELS.get(counter, (counter,))
        hits = [v for k, v in self.trace.ops.items()
                if any(n in k for n in names)]
        n = sum(c for c, _ in hits)
        if not n or self.dropped.get(counter):
            return None
        return sum(t for _, t in hits) / n / 1e3

    def run_kernel(self):
        """The whole-run kernel the requests launched, or None."""
        for name in RUN_KERNELS:
            if self.launches.get(name):
                return name
        return None


def main(argv=None, *, device=None, root=ROOT) -> int:
    args = parse(argv)
    bench = spec.load_benchmark(root)
    here = root / "portbench"
    cell = spec.workload(bench, args.workload)
    config = spec.config_file(root, bench, cell["config"])
    traffic = spec.traffic_file(cell["traffic"], here)
    lim = check.limits(here, args.workload)
    import torch

    if device is None:
        if (not torch.cuda.is_available()
                or torch.cuda.device_count() < int(cell["chips"])):
            log(f"portbench: the cell needs {cell['chips']} CUDA card(s); "
                f"torch sees {torch.cuda.device_count()}")
            return 2
        device = torch.device("cuda", 0)
    device = torch.device(device)
    if int(traffic.get("clients", 1)) != 1:
        raise ValueError("the harness drives one client")

    from portbench.program import Program

    inputs = make_inputs(config, traffic, args.seed)
    program = Program(config, traffic, inputs, device)
    for _ in range(WARMUP_REQUESTS):
        t0 = time.perf_counter()
        out = program.request()
        sync(torch, device)
        warm_s = time.perf_counter() - t0
    facts = work_of(torch, program, out)
    n_rays = sum(x.shape[1] for x in out.fields[0])
    del out
    setup_s = time.perf_counter() - START
    log(f"portbench: {args.workload} seed {args.seed}: set-up "
        f"{setup_s:.3f} s, {n_rays} rays, nt {program.run_config.nt}")

    sampler = check.Sampler(args.seed, n_rays,
                            int(args.seconds / max(warm_s, 1e-3)))
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    traced, before, held = None, [], [None]
    walls, failed = [], 0
    t_start = time.perf_counter()
    if args.trace:
        from torch.profiler import (ProfilerActivity, profile,
                                    record_function)

        # Untraced requests first, for the requests' wall: once the
        # profiler has run, the host's launches stay slower.
        before, failed, t_start, _ = serve(
            torch, device, program, sampler, held,
            min(UNTRACED_SECONDS, args.seconds), 1)
        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        launches0 = program.launches()
        with profile(activities=acts) as prof:
            with record_function(WINDOW):
                t_walls, f1, _, _ = serve(
                    torch, device, program, sampler, held,
                    min(TRACE_SECONDS, args.seconds), TRACE_REQUESTS,
                    record=True)
        traced = (t_walls, program.launches(), prof)
        walls, failed = before + t_walls, failed + f1
    rest = max(0.0, args.seconds - (time.perf_counter() - t_start))
    w2, f2, t2, t_end = serve(torch, device, program, sampler, held, rest,
                              0 if walls or failed else 1)
    if not walls and not failed:
        t_start = t2
    walls = walls + w2
    failed += f2
    window_s = t_end - t_start
    if walls:
        q = np.percentile(np.array(walls) * 1e3, [0, 25, 50, 75, 95, 100])
        log(f"portbench: {len(walls)} requests in {window_s:.3f} s; wall ms "
            "min, quartiles, p95, max " + " ".join(f"{x:.3f}" for x in q))
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    dev_info = device_platform(torch, device)
    dev_info["memory_peak_bytes"] = int(peak)

    result_metrics, breakdown = {}, None
    if traced is None and walls:
        cfg = program.run_config
        steps = work.ray_steps(n_rays, cfg.nt)
        values = {
            "ray_steps_per_s": steps * len(walls) / window_s,
            "run_ms_p95": float(np.percentile(walls, 95)) * 1e3,
            "setup_s": setup_s,
        }
        for m in spec.metrics_of(bench, "end_to_end", args.workload):
            if m["name"] in values:
                result_metrics[m["name"]] = {"value": values[m["name"]],
                                             "unit": m["unit"]}
    elif traced is not None:
        t_walls, launches1, prof = traced
        summary = summarize(prof.events())
        del prof, traced
        delta = {k: launches1[k] - launches0[k] for k in launches0}
        dropped = {}
        for name, n in delta.items():
            seen = launches_seen(summary.ops, name)
            if device.type == "cuda" and seen != n:
                dropped[name] = n - seen
                log(f"portbench: the trace holds {seen} {name} launches of "
                    f"the {n} the program counted: records were dropped")
        log(f"portbench: traced {summary.requests} requests, "
            f"{sum(delta.values())} counted launches ({delta}), window "
            f"{summary.window_us * 1e-6:.6f} s, device busy "
            f"{summary.busy_us * 1e-6:.6f} s")
        ctx_walls = before or t_walls
        ctx = Context(trace=summary, requests=summary.requests,
                      request_ms=statistics.mean(ctx_walls) * 1e3
                      if ctx_walls else None,
                      launches=delta, dropped=dropped, peak_bytes=peak,
                      facts=facts, bounds=work.bounds(facts))
        for m in spec.metrics_of(bench, "per_layer", args.workload):
            value = spec.reader(m["name"], here)(ctx)
            if value is not None:
                result_metrics[m["name"]] = {"value": float(value),
                                             "unit": m["unit"]}
        dev_info["busy_s"] = summary.busy_us * 1e-6
        dev_info["window_s"] = summary.window_us * 1e-6
        breakdown = {"device_ops": top({k: t for k, (_, t)
                                        in summary.ops.items()}),
                     "idle_gaps": top(summary.gaps)}

    # The program's state goes before the reference runs on the card; its
    # prepared states and the judged rows stay.
    program_states = program.states
    judged = sampler.judged() + ([check.whole(held[0])] if held[0] is not None
                              else [])
    del program, held
    t_ref = time.perf_counter()
    readings = {}
    if judged:
        ref = check.Reference(config, inputs, device, seed=args.seed)
        readings = ref.judge(program_states, judged)
    checks = check.checks(readings, lim, bool(judged))
    log(f"portbench: reference {time.perf_counter() - t_ref:.3f} s over "
        f"{sum(j.idx.numel() for j in judged)} judged rays")
    counts = {k: v for k, v in readings.items()
              if k.startswith(("excused.", "reference."))}
    if counts:
        log(f"portbench: deaths excused and rays the reference gave up: "
            f"{json.dumps(counts)}")

    found = imports.forbidden(sys.modules)
    if found:
        log(f"portbench: the process holds {', '.join(found)}")
        return 3
    correct = check.correct(checks, failed)
    result = {"correct": correct, "attempted": len(walls) + failed,
              "failed": failed, "metrics": result_metrics,
              "device": dev_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                        for c in checks}
    for c in checks:
        log(f"check {c.name} {c.value} limit {c.limit}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
