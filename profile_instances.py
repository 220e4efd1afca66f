#!/usr/bin/env python3
"""Time the RK4 and exact kernels' instances against each other on one card.

    python3 profile_instances.py [--parts report,sweep,tiled,stall]
                                 [--parent DIR]

The instances (``kernels.INSTANCES``, ``csrc/ray_rhs.cuh``) run in turns
(chip_smoke's ``TURNS``) on the same inputs, each bitwise equal to Lane's
output there, with the launcher's choice (``tracer.rk4_instance``,
``rk45.exact_instance``) and its time over Lane's printed beside them.
All runs use chip_smoke.py's climatology background. Parts:

  report  each RHS, RK4, exact and dense kernel instance's registers and spills
          (the build's ``-Xptxas -v`` report in ``nvcc.log``) and SASS
          instruction counts (``cuobjdump -sass``, where the toolkit has
          it): all, and the loads, shared loads and stores, shuffles and
          special-function (MUFU) instructions among them; with
          ``--parent DIR`` (a checkout of another commit, as ``git archive``
          unpacks it) also that checkout's kernels, built there, and for
          each kernel of both its registers and spills there and here and
          whether its SASS is the same instruction for instruction (a
          one-type instance ``<T, T, ...>`` is read as the older
          ``<T, ...>``, and a static instance, whose time flag is false,
          as the older one without the flag)
  sweep   the first R lanes of the production seeding's entry state, R over
          SWEEP_LANES, float32, float64 and mixed precision (a float64
          state over the float32 background): RK4 over SWEEP_STEPS steps
          and the first 16-bound exact group (in mixed precision the
          whole-run kernel over that one group: the single-group kernel
          has no mixed instance)
  tiled   the default source matrix's 4,288 lanes repeated to R lanes, R
          over TILED_LANES, float32: the whole ``RunConfig()`` RK4 run
          (1,080 steps) and the README exact run cut to README_DAYS days
  stall   the README exact run over TRUNC_DAYS days through the whole-run
          kernel: from day 49 one lane stalls at the max_iters backstop, and
          its trips are most of the run

Prints the card (``nvidia-smi`` name and power limit) first. Imports no
JAX.
"""

from __future__ import annotations

import argparse
import re
import shutil
import subprocess
import sys
from pathlib import Path

import chip_smoke as cs

#: The sweep: lane counts (the first R lanes of the production seeding's
#: entry state) and RK4 steps.
SWEEP_LANES = (1, 8, 16, 32, 64, 128, 512, 2048, 4288, 5120, 6144, 7168,
               8192, 16384, 32768)
SWEEP_STEPS = 120
#: The default source matrix's lanes, repeated to these counts.
TILED_LANES = (4288, 5120, 6144, 7168, 8192)


def demangle(names):
    """Readable kernel names (c++filt where the toolkit's host has it). A
    relocatable unit's kernel carries a ``__nv_static_..._`` prefix before
    its mangled name, which is dropped."""
    if not names or shutil.which("c++filt") is None:
        return {n: n for n in names}
    mangled = [n[n.index("_ZN"):] if n.startswith("__nv_static_")
               and "_ZN" in n else n for n in names]
    out = subprocess.run(["c++filt"], input="\n".join(mangled),
                         capture_output=True, text=True).stdout.splitlines()
    short = [o.replace("(anonymous namespace)::", "").removeprefix("void ")
             .split("(")[0] for o in out]
    return dict(zip(names, short))


def sass_of(lib):
    """Each kernel's SASS instructions (``cuobjdump -sass``), by mangled
    name; empty where the toolkit has no cuobjdump."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(cuobjdump).is_file():
        return {}
    text = subprocess.run([cuobjdump, "-sass", str(lib)],
                          capture_output=True, text=True).stdout
    out, fn = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            out[fn] = []
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", line)
        if m and fn:
            out[fn].append(m.group(1))
    return out


#: The position of the time flag among each kernel's template arguments
#: (csrc/: rhs_kernel<T, kTime>, rk4_kernel<S, F, kTime, I>,
#: dense_kernel<S, F, kRun, kTime>, exact_kernel<S, F, kRun, kBarrier,
#: kTime, I>).
TIME_FLAG = {"rhs_kernel": 1, "rk4_kernel": 2, "dense_kernel": 3,
             "exact_kernel": 4}


def common_name(pretty):
    """A kernel's name as both trees can have it: a one-type instance
    <T, T, ...> as the older <T, ...>; a static instance without its time
    flag, a time instance as ``<kernel>_time<...>`` without it."""
    m = re.match(r"(\w+_kernel)<(.*)>$", pretty)
    if m and m.group(1) in TIME_FLAG:
        args = m.group(2).split(", ")
        pos = TIME_FLAG[m.group(1)]
        if len(args) > pos and args[pos] in ("true", "false"):
            flag = args.pop(pos)
            pretty = (m.group(1) + ("_time" if flag == "true" else "")
                      + "<" + ", ".join(args) + ">")
    return re.sub(r"<(float|double), \1", r"<\1", pretty)


def compare_parent(lib, parent):
    """Build the kernels of the checkout ``parent`` there and print, for
    each kernel of both libraries, its registers and spills in each and
    whether its SASS is the same."""
    built = Path(subprocess.run(
        [sys.executable, "-c", "from rwrt_tpu_torch.kernels import build; "
         "print(build.build())"], cwd=parent, capture_output=True,
        text=True, check=True).stdout.strip().splitlines()[-1])

    def by_name(path):
        code = sass_of(path)
        pretty = demangle(list(code))
        return {common_name(pretty[n]): c for n, c in code.items()}

    def regs_by_name(path):
        regs = regs_of(path)
        pretty = demangle(list(regs))
        return {common_name(pretty[n]): r for n, r in regs.items()}

    old_regs, new_regs = regs_by_name(built), regs_by_name(lib)
    for n in sorted(set(old_regs) & set(new_regs)):
        o, w = old_regs[n], new_regs[n]
        print(f"registers {n}: parent {o.get('regs', '?')} (spill "
              f"{o.get('spill', '?')}), this tree {w.get('regs', '?')} (spill "
              f"{w.get('spill', '?')}), "
              f"{'unchanged' if o == w else 'CHANGED'}")
    old, new = by_name(built), by_name(lib)
    for n in sorted(set(old) & set(new)):
        same = old[n] == new[n]
        print(f"SASS {n}: parent {len(old[n])} instructions, this tree "
              f"{len(new[n])}, {'the same' if same else 'different'}")
    print(f"SASS: only in this tree {sorted(set(new) - set(old))}; only in "
          f"the parent {sorted(set(old) - set(new))}")


def regs_of(lib):
    """Each kernel's registers and (spill stores, spill loads) bytes from
    the build's ``nvcc.log`` beside library ``lib``, by mangled name."""
    regs, name = {}, None
    for line in (lib.parent / "nvcc.log").read_text().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            regs.setdefault(name, {})["spill"] = (int(m.group(1)),
                                                  int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            regs.setdefault(name, {})["regs"] = int(m.group(1))
    return regs


def part_report(run):
    from rwrt_tpu_torch.kernels import build

    lib = build.build()
    regs = regs_of(lib)
    sass = {}
    for fn, code in sass_of(lib).items():
        counts = sass[fn] = {"all": len(code)}
        for ins in code:
            op = re.sub(r"^@!?U?P\w+\s+", "", ins).split(" ")[0]
            op = op.split(".")[0]
            if op in ("LDG", "LDS", "STS", "SHFL", "MUFU"):
                counts[op] = counts.get(op, 0) + 1
    names = sorted(n for n in set(regs) | set(sass)
                   if re.search(r"(rk4|exact|rhs|dense)_kernel", n))
    pretty = demangle(names)
    for n in names:
        r, c = regs.get(n, {}), sass.get(n, {})
        print(f"kernel {pretty[n]}: {r.get('regs', '?')} registers, spill "
              f"stores/loads {r.get('spill', '?')}; SASS "
              + (", ".join(f"{k} {c.get(k, 0)}" for k in
                           ("all", "LDG", "LDS", "STS", "SHFL", "MUFU"))
                 if c else "not available"))
    if run.parent is not None:
        compare_parent(lib, run.parent)


def same_all(out, ref, names=None):
    """Every output of ``out`` bitwise equal to ``ref``'s (by field name, or
    position)."""
    if names:
        return all(cs.same(getattr(out, n), getattr(ref, n)) for n in names)
    return all(cs.same(a, b) for a, b in zip(out, ref))


def part_sweep(run):
    torch = run.torch
    from rwrt_tpu_torch import tracer
    from rwrt_tpu_torch.models import ray
    from rwrt_tpu_torch.solvers import rk45

    cfg = cs.production_config(run.rt, bound_mode="exact", pin_limit=None,
                               interval_batch=16)
    f32, f64 = torch.float32, torch.float64
    for name, dtype, state in (("float32", f32, None),
                               ("float64", f64, None),
                               ("mixed", f32, f64)):
        bg, args, _, _ = run.run_inputs(dtype, cfg, state=state)
        _, y0, ug0, vg0, h0, f0, bounds_g, _, cut_off, rtol, atol, mstep = args
        key = (y0.dtype, dtype)
        dt = rk45.as_scalar(cfg.tstep, y0.dtype)
        for r in SWEEP_LANES:
            y, ug, vg, h, f = (x[..., :r].contiguous()
                               for x in (y0, ug0, vg0, h0, f0))
            rk = (bg, y, ug, vg, dt, SWEEP_STEPS + 1, cut_off)
            ref = tracer._run_rk4_cuda(*rk, "lane")
            tag = f"sweep rk4 {name} R={r}"
            cs.in_turns(run, tag, lambda n: tracer._run_rk4_cuda(*rk, n), 3,
                        lambda out: same_all(out, ref))
            cs.print_choice(run, tag, tracer.rk4_instance(r, key), False)
            if state is not None:
                one = (bg, y, ug, vg, h, f, bounds_g[:1], bounds_g.shape[1],
                       cut_off, rtol, atol, mstep)

                def launch(inst):
                    return tracer._exact_run_cuda(*one, instance=inst)

                gref = launch("lane")
                tag = f"sweep exact_run one group {name} R={r}"
                cs.in_turns(run, tag, launch, 3, lambda out: same_all(
                    out, gref, ("ys", "ugs", "vgs", "lane_att")))
                cs.print_choice(run, tag, rk45.exact_instance(r, key), False)
                continue
            carry = (y, torch.zeros_like(h), h, f, y[0].clone(), y[1].clone())
            tail = (bounds_g[0], *carry[4:], cut_off, rtol, atol, mstep)

            def launch(inst):
                return rk45._integrate_group_cuda(
                    ray.RayRHS(bg), None, *carry[:4], *tail, cs.MAX_ITERS,
                    None, inst)

            gref = launch("lane")
            tag = f"sweep exact_group {name} R={r}"
            cs.in_turns(run, tag, launch, 3,
                        lambda out: same_all(out[:7], gref[:7]))
            cs.print_choice(run, tag, rk45.exact_instance(r, dtype, run=False),
                            False)


def tile(xs, r):
    """Each (..., R0) tensor of ``xs`` with its lanes repeated to r."""
    import torch

    return [x.index_select(-1, torch.arange(r, device=x.device) % x.shape[-1])
            .contiguous() for x in xs]


def part_tiled(run):
    torch = run.torch
    from rwrt_tpu_torch import tracer
    from rwrt_tpu_torch.solvers import rk45

    dtype = torch.float32
    dcfg = cs.default_config(run.rt)
    bg, y0, ug0, vg0, _ = run.entry(dtype, dcfg)
    ecfg = cs.readme_config(run.rt)
    _, args, _, _ = run.run_inputs(dtype, ecfg, ecfg)
    for r in TILED_LANES:
        y, ug, vg = tile((y0, ug0, vg0), r)
        rk = (bg, y, ug, vg, rk45.as_scalar(dcfg.tstep, dtype), dcfg.nt,
              rk45.as_scalar(dcfg.cut_off_rad, dtype))
        ref = tracer._run_rk4_cuda(*rk, "lane")
        tag = f"tiled rk4 default R={r}"
        cs.in_turns(run, tag, lambda n: tracer._run_rk4_cuda(*rk, n), 2,
                    lambda out: same_all(out, ref))
        cs.print_choice(run, tag, tracer.rk4_instance(r, dtype), False)
        ex = (args[0], *tile(args[1:6], r), *args[6:])

        def launch(inst):
            return tracer._exact_run_cuda(*ex, instance=inst)

        eref = launch("lane")
        tag = f"tiled exact README {cs.README_DAYS} days R={r}"
        cs.in_turns(run, tag, launch, 2,
                    lambda out: same_all(out, eref, ("ys", "ugs", "vgs",
                                                     "lane_att", "trunc")))
        cs.print_choice(run, tag, rk45.exact_instance(r, dtype), False)


def part_stall(run):
    torch = run.torch
    from rwrt_tpu_torch import tracer
    from rwrt_tpu_torch.solvers import rk45

    cfg = cs.readme_config(run.rt, cs.TRUNC_DAYS)
    _, args, _, _ = run.run_inputs(torch.float32, cfg, cfg)

    def launch(inst):
        return tracer._exact_run_cuda(*args, cs.MAX_ITERS, instance=inst)

    ref = launch("lane")
    trips = ref.lane_att.sum(dim=0)
    tag = f"stall exact README {cs.TRUNC_DAYS} days"
    times = cs.in_turns(run, tag, launch, 1, lambda out: same_all(
        out, ref, ("ys", "ugs", "vgs", "lane_att", "trunc")))
    top = int(trips.max())
    print(f"  {tag}: R={args[1].shape[1]}, truncated lane-groups "
          f"{int(ref.trunc.sum())}, longest lane {top} trips; us per trip "
          "of that lane " + ", ".join(
              f"{n} {' / '.join(f'{t / top * 1e3:.3f}' for t in ts)}"
              for n, ts in times.items()))
    cs.print_choice(run, tag, rk45.exact_instance(args[1].shape[1],
                                                  torch.float32), False)


PARTS = {"report": part_report, "sweep": part_sweep, "tiled": part_tiled,
         "stall": part_stall}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parts", default=",".join(PARTS))
    ap.add_argument("--parent", type=Path, default=None)
    args = ap.parse_args()
    parts = args.parts.split(",")
    unknown = set(parts) - set(PARTS)
    if unknown:
        ap.error(f"unknown parts {sorted(unknown)}; of {sorted(PARTS)}")

    import torch

    if not torch.cuda.is_available():
        print("profile_instances: no CUDA device", file=sys.stderr)
        return 1
    import rwrt_tpu_torch as rt

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    run = cs.Run(torch, rt)
    run.parent = args.parent
    for p in parts:
        PARTS[p](run)
        print(f"part {p} done", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
