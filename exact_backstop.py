#!/usr/bin/env python3
"""Find the lanes of an exact-bound run that reach the max_iters backstop.

    python3 exact_backstop.py [--path exact|readme] [--lanes 6]
                              [--state-dtype compute|float64]
                              [--out DIR (profile_out)]

On one CUDA card, runs ``profile_main_path.py``'s exact run (``exact``: the
production seeding, 100,800 rays, 30 days; ``readme``: the README's Usage
run, 6,615 rays, 90 days), float32, through the port's whole-run exact
kernel on ``trace_rays``' own entry state (``chip_smoke.Run.run_inputs``),
and lists the lanes that spend the 1,000,000-trip backstop in a group: per
lane its ray (root, source, zonal wavenumber), its first such group, its
trips per group, and (t, h) where the backstop left it, beside the spacing
of float32 numbers at that t. For the first ``--lanes`` of them (earliest
group first) it writes ``DIR/exact_backstop_<path>.npz``: the background's
winds, the lanes' sources, their carry (y, t, h, f, prev_lon, prev_lat) at
the entry of that group and its (t, h) at the group's exit, the group's
bounds and the run's scalars, so that ``backstop_jax.py`` can run the JAX
package on the same lanes. With ``--state-dtype float64`` the run is in
mixed precision (a float64 state, t and h over the float32 background) and
the file is ``exact_backstop_<path>_float64.npz``; where no lane reaches
the backstop, it says so and writes nothing. Imports no JAX.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import numpy as np

import chip_smoke as cs
import profile_main_path as pmp


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--path", choices=("exact", "readme"), default="exact")
    ap.add_argument("--lanes", type=int, default=6)
    ap.add_argument("--state-dtype", choices=("compute", "float64"),
                    default="compute")
    ap.add_argument("--out", type=Path, default=Path("profile_out"))
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("exact_backstop: no CUDA device", file=sys.stderr)
        return 1
    import rwrt_tpu_torch as rt
    from rwrt_tpu_torch import tracer

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    run = cs.Run(torch, rt)
    cfg = pmp.config(rt, args.path)
    matrix = cfg if args.path == "readme" else None
    state = torch.float64 if args.state_dtype == "float64" else None
    _, run_args, _, idx = run.run_inputs(torch.float32, cfg, matrix, state)
    if idx is None:
        idx = np.arange(run_args[1].shape[1])
    out = tracer._exact_run(*run_args, max_iters=cs.MAX_ITERS)
    capped = (out.lane_att == cs.MAX_ITERS).cpu().numpy()   # (groups, R)
    stuck = np.nonzero(capped.any(axis=0))[0]
    first = capped[:, stuck].argmax(axis=0)
    order = np.lexsort((stuck, first))
    stuck, first = stuck[order], first[order]
    print(f"path {args.path}, state {run_args[1].dtype}: "
          f"{out.lane_att.shape[1]} lanes, "
          f"{out.lane_att.shape[0]} groups of {run_args[6].shape[1]} bounds; "
          f"{int(out.trunc.sum())} truncated lane-groups; {stuck.size} lanes "
          f"reach the {cs.MAX_ITERS:,}-trip backstop; most trips per group "
          f"{out.lane_att.amax(dim=1).tolist()}")
    if stuck.size == 0:
        print("no lane reaches the backstop: nothing to write")
        return 0

    nsource = (cfg.nsource if matrix is not None else cs.N_SOURCES)
    nzwn = cfg.nzwn
    if matrix is not None:
        slon, slat = tracer.source_matrix(cfg.sw_lon, cfg.sw_lat, cfg.dlon,
                                          cfg.dlat, cfg.nnx, cfg.nny)
    else:
        slon, slat = run.slon, run.slat
    ray = idx[stuck]
    root, src, zi = (ray // (nsource * nzwn), ray // nzwn % nsource,
                     ray % nzwn)
    zwn = cfg.zwn_array()[zi]
    t_end = out.carry[1][stuck].cpu().numpy()
    h_end = out.carry[2][stuck].cpu().numpy()
    att = out.lane_att[:, stuck].cpu().numpy()
    for j in range(stuck.size):
        print(f"lane {stuck[j]} (ray {ray[j]}: root {root[j]}, source "
              f"({np.degrees(slon[src[j]]):.4f}E, "
              f"{np.degrees(slat[src[j]]):.4f}N), zwn {zwn[j]:g}): first "
              f"backstop group {first[j]}; at the end t {float(t_end[j])!r} "
              f"s, h {float(h_end[j])!r} s, {t_end.dtype} spacing at t "
              f"{float(np.spacing(t_end[j]))!r} s; trips per group "
              f"{att[:, j].tolist()}")

    keep = slice(0, min(args.lanes, stuck.size))
    lanes, groups = stuck[keep], first[keep]
    # The carry at the entry of each lane's group g and at its exit: the
    # run cut to its first g and g + 1 groups (lanes are independent, so a
    # cut changes no lane's path).
    dtypes = [x.cpu().numpy().dtype for x in out.carry]
    dtypes += dtypes[1:3]
    carry = [np.empty((5, lanes.size) if k in (0, 3) else lanes.size,
                      dtypes[k]) for k in range(8)]
    bounds_g = run_args[6]
    for g in np.unique(groups):
        sel = groups == g
        take = torch.as_tensor(lanes[sel], device=run.dev)
        for cut in (g, g + 1):
            part = tracer._exact_run(*run_args[:6], bounds_g[:cut],
                                     int(cut) * bounds_g.shape[1],
                                     *run_args[8:], max_iters=cs.MAX_ITERS)
            got = [x.index_select(-1, take).cpu().numpy() for x in part.carry]
            for k, x in (enumerate(got) if cut == g
                         else ((6, got[1]), (7, got[2]))):
                carry[k][..., sel] = x
    args.out.mkdir(parents=True, exist_ok=True)
    tag = args.path + ("_float64" if state is not None else "")
    path = args.out / f"exact_backstop_{tag}.npz"
    np.savez(
        path, u=run.u, v=run.v, lat=run.lat, lon=run.lon, lane=lanes,
        ray=ray[keep], root=root[keep], source_lon=slon[src[keep]],
        source_lat=slat[src[keep]], zwn=zwn[keep], group=groups,
        bounds=bounds_g[groups].cpu().numpy(), y=carry[0], t=carry[1],
        h=carry[2], f=carry[3], prev_lon=carry[4], prev_lat=carry[5],
        t_exit=carry[6], h_exit=carry[7],
        lane_att=att[:, keep], tstep=cfg.tstep, rtol=cfg.rtol,
        atol=cfg.atol, min_step=float(run_args[11]),
        cut_off=float(run_args[8]), max_iters=cs.MAX_ITERS)
    print(f"wrote {path}: {lanes.size} lanes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
