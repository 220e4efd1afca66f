#!/usr/bin/env python3
"""The readings a cell's limits are set from: the program's, and its
control's, the plain reference in the precision below the configuration's
put in the program's place.

    python3 portbench/control.py --workload CELL --seeds 1,2,3
    python3 portbench/control.py --config NAME --traffic MIX --seeds 1,2,3

For each seed it makes the run's inputs as ``run.py`` does and prints one
JSON line for each side: the program serving one request over them, judged
as ``run.py`` judges a window's last (``check.py``), and the control
judged the same way. A float64 configuration's control runs in float32; a
float32 one's prepares the basic state in bfloat16 and integrates in
float32. A configuration that integrates by another method than RK4 is
read on its basic state and seeds alone. ``--sides`` picks the sides.

This is no part of a benchmark run. It needs a CUDA card unless
``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if __name__ == "__main__":
    sys.path[0] = str(ROOT)

from portbench import check, spec  # noqa: E402
from portbench.inputs import make_inputs  # noqa: E402

#: The control's (field dtype, state dtype) for a configuration's cal_dtype.
LOWER = {"float64": ("float32", "float32"),
         "float32": ("bfloat16", "float32")}


def program_readings(config, traffic, inputs, ref, device):
    import torch

    from portbench.program import Program

    program = Program(config, traffic, inputs, device)
    out = program.request()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    judged = check.whole(out)
    if ref.integrator != "rk4":
        judged = judged._replace(rows=judged.rows[:, :1])
    return ref.judge(program.states, [judged])


def control_readings(config, inputs, ref, device):
    import torch

    field, integ = LOWER[config["run"]["cal_dtype"]]
    ctrl = check.Reference(config, inputs, device, getattr(torch, integ),
                           getattr(torch, field))
    if ctrl.integrator == "rk4":
        rows = ctrl.rows()
    else:
        s = ctrl.seeds
        rows = torch.cat([s.y0, s.ug0[None], s.vg0[None]])[:, None]
    return ref.judge(ctrl.states, [check.Judged(
        rows, torch.arange(rows.shape[-1]))])


def main(argv=None, root: Path = ROOT) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload")
    ap.add_argument("--config")
    ap.add_argument("--traffic")
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--sides", default="program,control")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    here = root / "portbench"
    if args.workload:
        bench = spec.load_benchmark(root)
        cell = spec.workload(bench, args.workload)
        config = spec.config_file(root, bench, cell["config"])
        mix = cell["traffic"]
    else:
        config = json.loads((here / "configs" / f"{args.config}.json")
                            .read_text())
        mix = args.traffic
    traffic = spec.traffic_file(mix, here)
    device = torch.device(args.device)
    name = args.workload or f"{args.config}.{mix}"
    for seed in (int(s) for s in args.seeds.split(",")):
        inputs = make_inputs(config, traffic, seed)
        ref = check.Reference(config, inputs, device)
        for side in args.sides.split(","):
            t0 = time.perf_counter()
            if side == "program":
                got = program_readings(config, traffic, inputs, ref, device)
            else:
                got = control_readings(config, inputs, ref, device)
            print(json.dumps({"workload": name, "seed": seed, "side": side,
                              "readings": got,
                              "seconds": time.perf_counter() - t0}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
