#!/usr/bin/env python3
"""The readings a cell's limits are set from: the program's, and its
control's, the plain reference in the precision below the configuration's
put in the program's place.

    python3 portbench/control.py --workload CELL --seeds 1,2,3
    python3 portbench/control.py --config NAME --traffic MIX --seeds 1,2,3

For each seed it makes the run's inputs as ``run.py`` does and prints one
JSON line for each side, with the reference's seconds (``reference_s``):

- ``program``: the program serving one request over them, judged as
  ``run.py`` judges a window's last (``check.py``);
- ``control``: the plain reference's own run in the precision below the
  configuration's, judged the same way. A float64 configuration's control
  runs in float32; a float32 one's prepares the basic state in bfloat16
  and integrates in float32. An RK45 configuration's control is the
  reference's RK45 run at the configuration's controls
  (``reference.adaptive.run``), with its attempts;
- ``loose`` (RK45 configurations): the program at 10x the tolerances its
  run uses (rtol after the port's floor of 100 units of rounding of the
  state's precision, and atol), judged against the configuration's
  reference: what the checks have to catch of a looser controller.

``--sides`` picks the sides.

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

import torch  # noqa: E402

from portbench import check, spec  # noqa: E402
from portbench.inputs import make_inputs  # noqa: E402

#: The control's (field dtype, state dtype) for a configuration's cal_dtype.
LOWER = {"float64": ("float32", "float32"),
         "float32": ("bfloat16", "float32")}
#: A ray whose row 0 is this far from the reference's seed (``check.gap``)
#: counts in ``seed_rays_off``.
SEED_OFF = 1e-3


def seed_rays_off(ref, judged) -> int:
    """The rays of ``judged`` whose row 0 is off the reference's seed by
    more than ``SEED_OFF``, or NaN where it is not."""
    s = ref.seeds
    want = torch.cat([s.y0, s.ug0[None], s.vg0[None]])[:, judged.idx]
    got = judged.rows[:, 0].to(want.device, torch.float64)
    d = torch.nan_to_num((got - want).abs() / (1 + want.abs()), nan=0.0)
    off = (d > SEED_OFF) | (torch.isnan(got) != torch.isnan(want))
    return int(off.any(0).sum())


def loosened(config, ref):
    """The configuration at 10x the tolerances its run uses."""
    config = json.loads(json.dumps(config))
    config["run"].update(rtol=10 * ref.controls.rtol,
                         atol=10 * ref.controls.atol)
    return config


def program_readings(config, traffic, inputs, ref, device):
    """(readings, the reference's seconds) of one request of the
    program."""
    from portbench.program import Program

    program = Program(config, traffic, inputs, device)
    out = program.request()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    judged, states = check.whole(out), program.states
    del program, out
    t0 = time.perf_counter()
    got = ref.judge(states, [judged])
    got["seed_rays_off"] = seed_rays_off(ref, judged)
    return got, time.perf_counter() - t0


def control_readings(config, inputs, ref, device):
    field, integ = LOWER[config["run"]["cal_dtype"]]
    ctrl = check.Reference(config, inputs, device, getattr(torch, integ),
                           getattr(torch, field))
    if ctrl.integrator == "rk4":
        rows = ctrl.rows()
        judged = check.Judged(rows, torch.arange(rows.shape[-1]))
    else:
        judged = ctrl.whole()
    t0 = time.perf_counter()
    got = ref.judge(ctrl.states, [judged])
    got["seed_rays_off"] = seed_rays_off(ref, judged)
    return got, time.perf_counter() - t0


def main(argv=None, root: Path = ROOT) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload")
    ap.add_argument("--config")
    ap.add_argument("--traffic")
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--sides", default="program,control,loose")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
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
    sides = args.sides.split(",")
    if config["run"].get("integrator", "rk4") == "rk4" and "loose" in sides:
        sides.remove("loose")
    for seed in (int(s) for s in args.seeds.split(",")):
        inputs = make_inputs(config, traffic, seed)
        ref = check.Reference(config, inputs, device, seed=seed)
        for side in sides:
            t0 = time.perf_counter()
            if side == "program":
                got, ref_s = program_readings(config, traffic, inputs, ref,
                                              device)
            elif side == "loose":
                got, ref_s = program_readings(loosened(config, ref),
                                              traffic, inputs, ref, device)
            else:
                got, ref_s = control_readings(config, inputs, ref, device)
            print(json.dumps({"workload": name, "seed": seed, "side": side,
                              "readings": got, "reference_s": ref_s,
                              "seconds": time.perf_counter() - t0}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
