#!/usr/bin/env python3
"""How chip_smoke.py's plain loops behave side by side on one CUDA card.

    python3 plain_stage_probe.py

The plain PyTorch versions of the whole-run kernels are host-bound Python
loops. This times one plain dense group (``tracer._dense_run_plain`` on
the production run's entry state, float32; float64 on its first N_SUBSET
lanes) alone and in 4 and 7 worker processes started together, the same
loop in 2 and 4 threads of one process (each on its own stream), and the
whole-run dense kernel alone and beside 3 worker processes' plain loops:
what ``chip_smoke.py``'s plain stage (``phase_plain_ahead``) rests on.
Prints the card's name and power limit first. Imports no JAX.

    python3 plain_stage_probe.py worker GROUPS DTYPE   (one worker)
"""
import json
import subprocess
import sys
import threading
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))
import chip_smoke as cs  # noqa: E402


def inputs(torch, rt, groups, dtype):
    """The dense_run phase's arguments (``cs.dense_run_args``) over their
    first ``groups`` groups, and the whole run's."""
    run = cs.Run(torch, rt)
    args, kw, _ = cs.dense_run_args(run, getattr(torch, dtype))
    return cs.groups_of(args, groups), kw, args


def worker(groups, dtype):
    import torch
    import rwrt_tpu_torch as rt
    from rwrt_tpu_torch import tracer

    t0 = time.perf_counter()
    cut, kw, _ = inputs(torch, rt, groups, dtype)
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    t1 = time.perf_counter()
    tracer._dense_run_plain(*cut, **kw)
    torch.cuda.synchronize()
    print(json.dumps(dict(setup=round(setup, 2),
                          plain=round(time.perf_counter() - t1, 2))),
          flush=True)


def start(n, groups, dtype):
    return [subprocess.Popen([sys.executable, __file__, "worker", str(groups),
                              dtype], stdout=subprocess.PIPE, text=True)
            for _ in range(n)]


def procs(n, groups, dtype):
    """n workers started together: the wall, each one's plain s and
    set-up s."""
    t0 = time.perf_counter()
    outs = [json.loads(p.communicate()[0].strip().splitlines()[-1])
            for p in start(n, groups, dtype)]
    return dict(n=n, wall=round(time.perf_counter() - t0, 2),
                plain=[o["plain"] for o in outs],
                setup=[o["setup"] for o in outs])


def main():
    import torch

    if not torch.cuda.is_available():
        print("plain_stage_probe: no CUDA device", file=sys.stderr)
        return 1
    import rwrt_tpu_torch as rt
    from rwrt_tpu_torch import kernels, tracer

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    t0 = time.perf_counter()
    kernels.library()
    print("build", round(time.perf_counter() - t0, 1), flush=True)
    for n in (1, 4, 7):
        print("procs float32", procs(n, 1, "float32"), flush=True)
    print("procs float64", procs(1, 1, "float64"), flush=True)

    cut, kw, full = inputs(torch, rt, 1, "float32")
    torch.cuda.synchronize()
    t = time.perf_counter()
    tracer._dense_run_plain(*cut, **kw)
    torch.cuda.synchronize()
    alone = time.perf_counter() - t
    for n in (2, 4):
        res = [None] * n

        def job(i):
            s = torch.cuda.Stream()
            with torch.cuda.stream(s):
                t1 = time.perf_counter()
                tracer._dense_run_plain(*cut, **kw)
                s.synchronize()
                res[i] = round(time.perf_counter() - t1, 2)

        t = time.perf_counter()
        threads = [threading.Thread(target=job, args=(i,)) for i in range(n)]
        for x in threads:
            x.start()
        for x in threads:
            x.join()
        print(f"threads {n}: wall {time.perf_counter() - t:.2f} s, each "
              f"{res}, alone {alone:.2f} s", flush=True)

    def kern():
        return tracer._dense_run(*full, **kw)

    alone_ms = [cs.cuda_ms(kern, 5) for _ in range(3)]
    ps = start(3, 3, "float32")
    time.sleep(25)  # past the workers' set-up
    beside = [cs.cuda_ms(kern, 5) for _ in range(3)]
    for p in ps:
        p.communicate()
    after = [cs.cuda_ms(kern, 5) for _ in range(3)]
    print(f"dense_run kernel ms alone {alone_ms}, beside 3 plain workers "
          f"{beside}, after {after}", flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["worker"]:
        worker(int(sys.argv[2]), sys.argv[3])
    else:
        sys.exit(main())
