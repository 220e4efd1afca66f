#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one CUDA card.

    python3 chip_smoke.py

Builds the port's kernels from ``rwrt_tpu_torch/csrc/``, holds each kernel
against its plain PyTorch version on the card, then runs the production
workload through ``rwrt_tpu_torch.trace_rays``: the 144 x 73 climatology
background, 4800 random sources x zwn 1..7 = 100,800 rays, 30 days at a 2 h
cadence, dense adaptive RK45 with pin-kill (500, 0), float32, and samples
the spectral fit of the same background at the day-10 positions. Then the
library's two default integrators on the same background, float32: RK4 in
``RunConfig()``'s default run (the 21 x 15 source matrix x zwn 1..7 =
6,615 rays, 90 days) and at the production seeding (30 days), and exact-
bound RK45 in the README's Usage run (the default sources, interval_batch
16, rtol = atol = 1e-6), its 90 days cut to 40: from day 49 one of its
lanes stalls at the max_iters backstop (a 52-day run checks that
``trace_rays`` then raises ``MaxItersTruncation``). Last, the same runs in
mixed precision (``state_dtype="float64"``: a float64 state over the
float32 background, the whole-run kernels' ``_mix`` instances): the dense
production run, its drift against float32 and float64, both RK4 runs and
the README run at its full 90 days, which the float64 time carry lets
finish. The chunked driver (``utils.checkpoint.trace_rays_chunked``) runs
the production seeding, the RK4 default run and the mixed runs again in
chunks, one launch each, and the 90-day production run through
``trace_rays``, which reroutes it there. Last, the same paths over a
time-varying background (the climatology in daily frames: the jet's
amplitude varying seasonally, its waves drifting east; ``rt.
prepare_time_varying``) through the kernels' time instances, and
``trace_rays_ensemble`` over four "reanalysis year" members. Then those
runs again over a device mesh whose three entries name the one card
(``rwrt_tpu_torch.parallel.sharding``), one launch per shard, bitwise.
Then the file-driven pipeline: ``python -m rwrt_tpu_torch --config run.json`` in
process over wind files of the climatology; over its production-size
trajectories the Li-Yang wave-ray flux (the flux kernel, and its file
driver on the trajectory file), exact death causes (``--report-exact``),
and the single-group kernels' time instances. Last, the gather probe
(``python -m rwrt_tpu_torch.probes.gather_probe``), the path of the last
TPU kernel, and gradients on the card through the plain, differentiable
route: ``optimize_seeds`` at 8,400 rays over 30 days. Last, four of the
port's five examples, each in its own process on the card.

Phases (any failed check raises; nothing is caught but the truncation the
exact_path phase requires and the chunk budget the chunked phase sets):
  plain_ahead  the plain stage: the plain runs that dense_run, rk4,
               exact_run, mixed_dense, mixed_rk4 and mixed_exact hold their
               kernels to, on the inputs those phases build, PLAIN_WORKERS
               at a time in worker processes (``python chip_smoke.py
               --plain``: host-bound loops, side by side) while no kernel
               is timed; each phase takes its run's result when its inputs
               are the stage's, bitwise (else runs it itself) and prints
               the plain ms its worker measured
  rhs          ``ray.rhs`` and ``ray.rhs_and_gv`` (the kernel) vs the
               plain ``ray._rhs_core`` on 100,800 seeded states; the
               wrapper's time beside the kernel alone (torch.profiler)
  dense_group  one 60-bound group on the 100,800-ray seed batch, the
               single-group kernel (``integrate_group_dense``) vs the plain
               loop, float64 and float32; its mixed instance bitwise
  dense_run    the whole-run kernel (``tracer._dense_run``: every group,
               the kill cascade, (ug, vg)) vs the plain ``_dense_run_plain``
               over all 360 bounds, bitwise: float32 on the production
               run's own entry state (the 60,784 compacted lanes), and the
               first 4,096 of those lanes in float32 (against the full
               run's rows) and in float64 (against the plain run); each
               run's warp occupancy (lanes in launch order, and as the
               repacking kernel's grid runs them) and the kernel
               instance's registers and spills
  dense_lone_lane  the production run's longest lane alone (R = 1):
               bitwise the full run's lane, its time the chain floor (no
               schedule of one-thread lanes can beat it), us per trip
  main_path    the run above through ``trace_rays``, launch counters reset
               just before it and read just after (one entry-stage launch
               and no RHS launch for the set-up, one whole-run launch, no
               single-group launch), step attempts from its ``stats``,
               peak device memory, rows bitwise equal to the dense_run
               phase's, the warp occupancy before and after the repacking;
               then a sampler stage (the spectral kernel at the
               day-10 positions) with its own counter, since ``trace_rays``
               never calls the sampler
  entry        the entry stage (``tracer.entry_stage``: f0 and the initial
               step in one launch of ``csrc/entry.cu``) on the production
               run's entry state at t = 0 and at per-lane times, float32,
               and in mixed precision and float64 on that seeding, bitwise
               against its plain route; wrapper timed, and at t = 0 in
               float32 the kernel alone and the plain route too, against
               its bound (the background rows its samples read)
  spectral     spectral kernel vs ``sample_spectral`` at the day-10
               positions and three NaN / out-of-range rows, in every operand
               case (SPECTRAL_CASES: float64 and float32 coefficients, with
               no rounding and with bf16, float16, float32 over float64 and
               the four float8 operand dtypes), to 1e-12 (float64) / 1e-5
               (float32) of each channel's max over the values finite in
               both, non-finite positions equal, two launches bitwise;
               kernel-alone, wrapper (with the coefficient repack) and plain
               times, achieved TFLOP/s, the bound (the MMA's tensor-core
               peak), the library call ``torch.matmul`` of the rounded
               (R, Mp) basis by the rounded (Mp, L * C) coefficients, and
               per channel the coefficients each cast made 0, inf or NaN;
               then the kernel's operand rounding (``round_on_card``)
               bitwise ``round_operands`` on 2^24 values in [-1, 1] from
               float32 and from float64 into each operand dtype
  rk4          the RK4 kernel (``tracer._run_rk4``) vs the plain
               ``_run_rk4_plain`` over all 360 steps of the production
               seeding's entry state (60,784 lanes), float32, and its first
               4,096 lanes in float64, bitwise; the kernel's time there and
               on the default run's entry state; every instance
               (``kernels.INSTANCES``) bitwise and timed in turns
  exact_group  one 16-bound group (``integrate_group`` on CUDA) vs the plain
               loop on the production seeding's entry state, float32 and
               float64, bitwise; every instance bitwise and timed in turns;
               every instance of its mixed instance bitwise
  exact_run    the whole-run exact kernel (``tracer._exact_run``) vs the
               plain ``_exact_run_plain`` on the README run's entry state
               over README_DAYS days, float32, and on its first
               EXACT_SUBSET lanes over EXACT_DAYS days in float64, bitwise;
               every instance bitwise and timed in turns; the barrier
               flag's kernel (``_run_rk45`` on the card: one bound per
               group) vs the flagged plain run on that subset
  rk4_path    the two RK4 runs through ``trace_rays``, counters reset just
               before each and read just after: one RK4 launch each, no
               other whole-run launch, rows bitwise equal to the rk4 phase's;
               the kernels line reports the production run's launches
  exact_path   the README run through ``trace_rays`` the same way: one
               exact-run launch, no single-group or dense launch, rows
               bitwise equal to the exact_run phase's; wall, peak memory,
               step attempts; then over TRUNC_DAYS days, where a lane
               stalls at the max_iters backstop and ``trace_rays`` must raise
               ``MaxItersTruncation``; the longest lane's us per trip there,
               and that lane alone over TRUNC_DAYS days (backstop
               LONE_MAX_ITERS) in every instance in turns
  chunked      the chunked driver, every counter reset just before each
               run and read just after: the production run in 6 chunks of
               60 (one dense launch each, rows bitwise equal to main_path's,
               its 6,893,062 attempts); cut by a 2-chunk budget with a
               checkpoint and streamed history, then resumed (bitwise); on
               CHUNK_PLAIN_SOURCES sources over 2 chunks against the driver
               with ``tracer._dense_run`` set to its plain version
               (bitwise); the 90-day production run through ``trace_rays``
               (rerouted: 17 launches, CPU rows, no non-finite alive lane;
               the wall split into kernel, device-to-host copy, host
               scatter, compaction and the rest, peak device memory, host
               history bytes); the RK4 default run in chunks of 64, rows
               bitwise equal to rk4_path's
  mixed_dense  the production run in mixed precision: the dense kernel's
               mixed instance on its entry state, timed, and on its first
               N_SUBSET lanes bitwise against the plain run; then through
               ``trace_rays`` (one launch, seven float64 outputs, rows
               bitwise equal to the kernel's)
  mixed_drift  the production run through ``trace_rays`` in float32, mixed
               and float64: each run's attempts and dense kernel time, and
               the day-30 median great-circle drift of float32 and of mixed
               against float64 (a record, not a gate)
  mixed_rk4    both RK4 runs in mixed precision: the kernel against the
               plain run, bitwise, every instance in turns, and through
               ``trace_rays`` as rk4_path
  mixed_exact  the README run over MIXED_README_DAYS days in mixed
               precision: no lane-group at the backstop, every instance in
               turns, every instance bitwise against the plain run on
               EXACT_SUBSET lanes x EXACT_DAYS days and, with the barrier
               flag, against the flagged plain run; then through
               ``trace_rays`` as exact_path, with no ``MaxItersTruncation``
  mixed_chunked  the mixed README run (90 days, chunks of 16: 68 exact
               launches) and the mixed dense production run (30 days,
               chunks of 60: 6 launches) through the chunked driver, float64
               rows bitwise equal to mixed_exact's and mixed_dense's
  time_rhs     the RHS kernel's time instance on 100,800 seeded states at
               per-lane times over the 31 daily frames, between them and
               past both ends, over the frames, a 4-member stack and a
               4-member x 31-frame stack, float32 and float64: bitwise
               against the plain ``_rhs_core``
  time_main_path  the production run over the 31 daily frames through
               ``trace_rays`` (counters reset just before and read just
               after: one dense launch, the time instance); its first
               N_SUBSET lanes over every group (each entered from the
               kernel's carry) bitwise against ``_dense_run_plain`` and
               against the full run's rows; kernel ms and wall beside the
               static run's
  time_entry   the entry stage's time instance on that run's entry state
               (t = 0, then per-lane times over and past the frames, in
               float32 and mixed), bitwise against the plain route, timed
  time_paths   the same, a lane subset over the first and the last group
               (the first and last TV_PLAIN_STEPS steps in RK4), for RK4 in
               ``RunConfig()``'s default run (90 days, 91 frames) in
               float32, mixed and float64, the README exact run in float32
               (40 days), mixed and float64 (90 days), and the dense
               production run in mixed and float64 (30 days)
  time_chunked the 30-day time-varying production run in 6 chunks (rows
               bitwise equal to time_main_path's) and the 90-day one
               through ``trace_rays``' reroute (17 chunks, the wall split)
  ensemble     ``trace_rays_ensemble``: 4 static members x the production
               seeding (403,200 rays, dense, pin, one launch of the time
               instance with the member map), and 2 time-varying members
               over the README's sources in RK4 and in exact mode; each
               member's rows bitwise equal to its own ``trace_rays``, a
               lane subset over every member, first and last group (steps),
               bitwise against the plain run;
               kernel ms and peak memory (the exact members in float64:
               float32's time carry stalls their lanes at the backstop)
  mesh         the device mesh: ``Mesh((cuda:0,) * MESH_SHARDS)``, every
               counter reset just before each run and read just after (one
               whole-run launch per shard, an adaptive run's entry stage
               once per shard): the dense production run (rows, (ug, vg)
               and attempts bitwise main_path's; its wall beside the
               meshless run's in turns), in mixed precision (mixed_dense's),
               the RK4 default run (rk4_path's), the README exact run
               (exact_path's), the 4-member ensemble (ensemble's); the
               production run in 6 chunks cut by a budget with a
               checkpoint, refused on resume under a mesh of 4, resumed
               (main_path's rows); the wavenumber maps bitwise the
               meshless maps; a CLI_SHORT_DAYS-day CLI run with --wnmaps
               with and without --mesh (a mesh of the card count): files
               bitwise, the report's "mesh" {"rays": 1}
  time_spectral  ``fit_spectral`` of the 31 frames (``fit_spectral_time``),
               ``lerp_coeffs`` at day 10, the spectral kernel at the
               time-varying run's day-10 positions against the plain
               sampler (the spectral phase's float32 bar)
  cli          ``rwrt_tpu_torch.__main__.main`` with --report, every
               counter reset just before each run and read just after:
               examples/reference_run.json (6,615 rays, RK4, float64, 90
               days) with --chunked (17 RK4 launches) and a basic-state
               file; the production-size run (80 x 60 sources x zwn 1..7 =
               100,800 rays, dense with pin, float32, 30 days) with
               --wnmaps (one dense launch); CLI_SHORT_DAYS-day runs over
               the README's sources: a 3-D wind file of 31 daily frames
               with a time variable (the time instance), a two-file
               ensemble (fused: one launch) and the reference run in
               root_order='fortran'. Each trajectory file bitwise equal,
               after the writer's rad2deg, to the same config through the
               library in process; the reports' termination counts equal
               to ``analyze`` on it; the basic-state and wavenumber-map
               files with the JAX writers' variables and shapes, bitwise
               the in-process state and ``compute_wavenumber_maps``, the
               reference run's basic state within BS_CPU_BAR of a CPU
               ``prepare`` and the maps within WN_CPU_BAR of the CPU
               port's on the same state; the
               fortran seeds' sorted roots against canonical order and
               their slots against the CPU port's. Prints each run's wall
               split (its report) and file bytes; keeps the files and the
               production-size run for the phases below
  flux         the flux kernel (``csrc/flux.cu``) on the production-size
               run's trajectories (100,800 rays x 361 rows) with the
               North Pacific box and |m| < 100: the region pass bitwise
               against its plain version (also with a keep carried from
               the first FLUX_BLOCK rows), timed with the kernel alone
               (CUDA events) and the rows its tiles read; the binning kernel against
               ``_accumulate_plain`` (count and carry bitwise, the other
               maps within FLUX_BAR: the atomics' order varies); kernel
               (and each of its launches under torch.profiler), wrapper,
               plain and ``index_add_`` times and the bounds (the bytes
               this run's data needs, and the kept rays' reads at 32-byte
               sectors); ``wave_ray_flux_chunked`` over a host copy
               against one-shot
  wrf_cli      ``python -m rwrt_tpu_torch.diagnostics.wrf_cli`` in process
               on the cli phase's production-size trajectory file, counters
               reset just before and read just after (one binning launch,
               one region pass), its wall split into load, bin, region
               statistics and write; the file's maps against
               ``wave_ray_flux`` in process
  classify     ``--report-exact`` on the reference run, the reference run
               over the cli phase's daily frames and the production-size
               run (no output files), counters reset just before and read
               just after: the report's exact causes equal to
               ``termination.cause_labels`` in process (RK4: four RHS
               launches, the time instance's over the frames: the RHS
               kernels' path; RK45: one entry-stage launch, no RHS launch,
               and one launch of the interval kernel,
               ``rk45.integrate_interval_rays``); labels,
               candidate states and trips per lane against the plain RHS's
               on the card, bitwise (an RK45 re-run cut at
               CLASSIFY_PLAIN_ITERS trips in both), and the report's own
               against them on the lanes it finished within the cut; the
               interval kernel timed at the report's entry and on its
               longest lane alone (the chain floor), and at the cut beside
               the plain loop alone on the same entry and cut (bitwise):
               the kernels line's ms and plain_ms
  group_time   the single-group kernels' time instances (``integrate_group``
               and ``integrate_group_dense`` over daily frames and over two
               members, float32, float64 and mixed, one launch each),
               bitwise against the plain loops
  gather       the gather probe's entry point (the JAX probe's shapes:
               131,072 int32 indices into a (145 * 73, width) float32
               table, a 30-link chain, widths 48, 128, 384), counters reset
               just before and read just after (its every link launched
               the kernel); at each width the kernel bitwise equal to
               ``index_select``; kernel alone, wrapper, plain,
               ``table[idx]`` and ``index_select`` times against the bound
  autodiff     float64 on the climatology, no kernel launched (counters
               reset at the start, read at the end): d(final lat)/d(wind
               scale) through prepare -> initialize -> 24 RK4 steps and
               d/d(seed lat) against central differences; the targeting
               gradient at 8,400 rays x 360 steps finite, and equal to
               central differences at four seeds over its first 5 days
               (over 30 days printed, not gated); ``optimize_seeds`` there
               for AD_STEPS Adam steps, its objective falling, wall and
               peak memory; ``trace_rays`` over a gradient-carrying state
               raises at the kernel guard
  examples     the port's examples (``examples/torch_*.py``) in their own
               processes with ``--device cuda``, started together, each
               one's end printed:
               the great-circle demo at full size (all 75 rays alive at day
               30, as in the JAX package's demo) and the plot script on its
               file (where matplotlib is installed), the flux demo
               (termination counts summing to the 1,890 ray slots), the
               adjoint demo (gradients against its central
               differences within AD_BARS); not the targeting demo (over
               60 s at ``RWRT_SMOKE=1``; the autodiff phase runs
               ``optimize_seeds`` at a user's size)

Each whole-run dense launch a phase makes (dense_run, main_path,
mixed_dense, time_main_path, time_paths, ensemble; chunked per chunk)
prints its warp occupancy in launch order and under the repacking
kernel's schedule (``profile_main_path.warp_occupancy``,
``repacked_occupancy``), the kernel's registers and spills
(``nvcc.log``) and, but in chunks, its chain floor (the longest lane
alone).

The RK4 and exact kernels' instances are timed in turns (TURNS) on the
same inputs at eight shapes (RK4 at production seeding and in the default
run, the first exact group at production seeding, the README exact run,
the lone stalled lane; in mixed precision both RK4 runs and the README
run); the launcher's choice at each is printed beside them, and the phase
fails if it ran slower than Lane there.
``profile_instances.py`` times them over lane counts and reports their
registers and SASS.

Each kernel's bound is the larger of its bytes (each input read once, each
output written once) over 3.35 TB/s and its flops over the data sheet's
peak for the units that do them: for the RHS and dense kernels, the flops
counted from the sources for this run's data (step attempts, rows kept)
over the peak outside the tensor cores (67 TFLOP/s float32, 34 float64;
a mixed instance's float32 and float64 flops each over its own peak, the
two times added);
for the spectral kernel, the product's flops over the card's tensor-core
peak for the case's operand type (``spectral_bound``), whatever MMA the
kernel runs: the float64 DMMA peak (67 TFLOP/s) for every case over
float64 coefficients (its sums are float64); over float32 coefficients,
three times over the TF32 peak (495) with no rounding (3xTF32, the
card's float32-exact product), the fp16 and bf16 peak (989) for float16,
bfloat16 and the two fnuz float8 types (no hardware format), the fp8
peak (1,979) for float8_e4m3fn and float8_e5m2;
the gather does no arithmetic: its bytes alone.

Prints the card (``nvidia-smi`` name and power limit), per-phase numbers,
one ``{"kernels": [...]}`` JSON line and, last, the ``{"ok": true, ...}``
JSON line. Exits nonzero without a result when no CUDA device is present or
when the port's package is not beside this script. Imports no JAX.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
DAY = 86400.0
HOUR = 3600.0
#: The production workload (the repo benchmark's seeding and horizon).
N_SOURCES = 4800
N_DAYS = 30
#: Lanes of the dense_run phase's float64 comparison.
N_SUBSET = 4096

#: H100 SXM data sheet: HBM bandwidth, the peaks outside the tensor cores
#: and the dense tensor-core peaks (TF32, fp16 and bf16, fp8, float64
#: DMMA).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12, "tf32": 495e12,
              "fp16": 989e12, "fp8": 1979e12, "fp64_tc": 67e12}
#: Flops counted from the sources (an add, multiply, divide, sqrt or
#: transcendental each): one ray_rhs evaluation (csrc/ray_rhs.cuh: 119 for
#: the sample, of which 84 blend the 12 fields; 19 group velocity; 44
#: tendencies and outputs); a step attempt of csrc/dense_run.cu beyond its
#: six evaluations (175 stage sums, 65 the 5th-order sum, 95 the error
#: terms, 7 norm and controller); an emitted bound (126 the quartic
#: interpolant); its kill test and (ug, vg) sample (18 + 138).
RHS_FLOPS = 182
ATTEMPT_FLOPS = 6 * RHS_FLOPS + 342
ROW_FLOPS = 126
CASCADE_FLOPS = 156
#: csrc/rk4_run.cu, a step: four evaluations, 65 for the stage inputs and
#: the update, the kill test and (ug, vg) sample. csrc/exact_run.cu: a step
#: attempt as dense_run.cu's plus 19 for the 7th stage's (ug, vg); a crossing
#: its kill test (18).
RK4_STEP_FLOPS = 4 * RHS_FLOPS + 65 + CASCADE_FLOPS
EXACT_ATTEMPT_FLOPS = ATTEMPT_FLOPS + 19
KILL_FLOPS = 18
#: Mixed precision (a float64 state over float32 fields): the same counts
#: split by the units that do them. A step attempt: the six evaluations and
#: the products and adds of the stage, 5th-order and error sums (125 + 55 +
#: 65) in float32; the step products and the adds into y (50 + 10), the
#: error's scaling (30), the norm and the controller (7) in float64; the
#: exact kernels' 7th-stage (ug, vg) in float32. An emitted row, its kill
#: test and (ug, vg) sample, and a crossing's kill test: float64. An RK4
#: step: the evaluations and the stage sum (25) in float32; the stage
#: inputs (30), the update (10), the kill test and (ug, vg) in float64.
MIX_ATTEMPT_FLOPS = {"float32": 6 * RHS_FLOPS + 245, "float64": 97}
MIX_EXACT_ATTEMPT_FLOPS = {"float32": 6 * RHS_FLOPS + 245 + 19,
                           "float64": 97}
MIX_RK4_STEP_FLOPS = {"float32": 4 * RHS_FLOPS + 25,
                      "float64": 40 + CASCADE_FLOPS}
assert sum(MIX_ATTEMPT_FLOPS.values()) == ATTEMPT_FLOPS
assert sum(MIX_EXACT_ATTEMPT_FLOPS.values()) == EXACT_ATTEMPT_FLOPS
assert sum(MIX_RK4_STEP_FLOPS.values()) == RK4_STEP_FLOPS
#: The production run's step attempts (dense, pin (500, 0), float32): the
#: dense kernel's arithmetic and its plain version give this count; a
#: change to either shows here.
DENSE_ATTEMPTS = 6_893_062
#: The README run's horizon here: 40 days (30 groups of 16 bounds), short
#: of the 38th group (day 49.3), where one lane stalls at the max_iters
#: backstop (a 1,000,000-trip group) and stays there: at 90 days that is 31
#: lane-groups, and the kernel takes 205 s (PERF.md, exact_backstop.py).
#: The truncation check runs 52 days (39 groups, two of them truncated).
README_DAYS = 40
TRUNC_DAYS = 52
#: The grouped adaptive run's backstop: trips per lane and group.
MAX_ITERS = 1_000_000
#: The exact_run phase's plain comparison: lanes and days.
EXACT_SUBSET = 2048
EXACT_DAYS = 16
#: The lone stalled lane's timing run: its backstop per group.
LONE_MAX_ITERS = 100_000
#: The exact_run phase's barrier-flag comparison: days of one-bound groups.
BARRIER_DAYS = 2
#: The order in which the RK4 and exact kernels' instances are timed.
TURNS = ("lane", "split8", "lane")
#: The README run's horizon in mixed precision: its full 90 days (the
#: float64 time carry does not stall where float32's does).
MIXED_README_DAYS = 90
#: The mixed dense run's plain comparison: its first groups (of 60 bounds),
#: on N_SUBSET lanes.
MIXED_PLAIN_GROUPS = 2
#: The chunked driver: the production run's chunks (its group), the RK4
#: default run's, the driver's default (what a rerouted ``trace_rays``
#: takes), and the rerouted production run's horizon.
CHUNK_STEPS = 60
RK4_CHUNK_STEPS = 64
DEFAULT_CHUNK_STEPS = 64
LONG_DAYS = 90
#: The chunked driver against its plain units: the first sources of the
#: production seeding (~4,100 lanes after compaction) over two chunks.
CHUNK_PLAIN_SOURCES = 324
CHUNK_PLAIN_CHUNKS = 2


#: The time-varying background: daily frames of the climatology (TV_DAYS
#: + 1 for the 30-day runs, LONG_DAYS + 1 for the 90-day ones), the jet's
#: amplitude varying by TV_SEASON over a TV_PERIOD-day cycle and the wave
#: patterns (u's wave 3, v's wave 2) drifting east TV_DRIFT degrees a day.
TV_SEASON = 0.15
TV_PERIOD = 90.0
TV_DRIFT = 3.0
TV_DAYS = 30
#: Ensemble members, "reanalysis years": each its jet's scale and its
#: waves' phase (degrees).
MEMBER_SCALES = (0.85, 0.95, 1.05, 1.15)
MEMBER_PHASES = (0.0, 30.0, 60.0, 90.0)
#: The time-varying paths' plain comparisons: lanes (the first ones, or
#: for an ensemble every R / TV_PLAIN_LANES-th), over the first and the
#: last group of a dense or exact run (every group of the main path's) and
#: the first and the last TV_PLAIN_STEPS steps of an RK4 run.
TV_PLAIN_LANES = 512
TV_PLAIN_STEPS = 60
#: Flops a timed sample adds to a static one (csrc/ray_rhs.cuh
#: lerp_frames): the second frame's row lerped (84), the time blend of the
#: 12 fields (36) and the frame fraction (3).
TIME_SAMPLE_FLOPS = 84 + 36 + 3


def time_sample_flops(bg):
    """The flops a sample of ``bg`` adds to a static one: TIME_SAMPLE_FLOPS
    where the kernel blends two frames (``ray.timed``: a 4-D stack without
    member_ids, every 5-D stack), else none (a static stack, an ensemble
    of static members)."""
    from rwrt_tpu_torch.models import ray

    return TIME_SAMPLE_FLOPS if ray.timed(bg) else 0

def climatology_background(nlon=144, nlat=73):
    """Solid-body-ish jet + stationary wave pattern, climatology-shaped
    (the repo's benchmark background)."""
    lat = np.linspace(-np.pi / 2, np.pi / 2, nlat)
    lon = np.arange(nlon) * 2 * np.pi / nlon
    u = (
        25.0 * np.cos(lat)[None, :] ** 2
        + 30.0 * np.exp(-(((np.degrees(lat)[None, :] - 35.0) / 12.0) ** 2))
        + 6.0 * np.cos(3 * lon)[:, None] * np.cos(lat)[None, :] ** 2
    )
    v = 4.0 * np.sin(2 * lon)[:, None] * np.cos(lat)[None, :]
    return u, v, lat, lon


def climatology_frames(n_frames, scale=1.0, phase=0.0, nlon=144, nlat=73):
    """``n_frames`` daily (u, v) frames of the climatology, made
    time-varying (TV_SEASON, TV_PERIOD, TV_DRIFT), a member's jet scaled by
    ``scale`` and its waves shifted by ``phase`` degrees: (u (T, nlon,
    nlat), v, lat, lon)."""
    lat = np.linspace(-np.pi / 2, np.pi / 2, nlat)
    lon = np.arange(nlon) * 2 * np.pi / nlon
    jet = (25.0 * np.cos(lat)[None, :] ** 2
           + 30.0 * np.exp(-(((np.degrees(lat)[None, :] - 35.0) / 12.0) ** 2)))
    us, vs = [], []
    for day in range(n_frames):
        amp = scale * (1.0 + TV_SEASON * np.sin(2 * np.pi * day / TV_PERIOD))
        x = lon - np.radians(TV_DRIFT * day + phase)
        us.append(amp * jet + 6.0 * np.cos(3 * x)[:, None]
                  * np.cos(lat)[None, :] ** 2)
        vs.append(4.0 * np.sin(2 * x)[:, None] * np.cos(lat)[None, :])
    return np.stack(us), np.stack(vs), lat, lon

def production_config(rt, **changes):
    """The production run's RunConfig (sources are passed separately),
    with ``changes`` applied."""
    import dataclasses

    return dataclasses.replace(rt.RunConfig(
        zwn=tuple(float(z) for z in range(1, 8)), tstep=2 * HOUR,
        ttotal=N_DAYS * DAY, integrator="rk45", bound_mode="dense",
        interval_batch=60, rtol=1e-6, atol=1e-6, min_step_factor=1e-3,
        cut_off=0.1, pin_limit=500, pin_mwn=0.0, cal_dtype="float32"),
        **changes)


def rk4_production_config(rt):
    """The production seeding in RK4 (30 days, 2 h steps)."""
    return production_config(rt, integrator="rk4", bound_mode="exact",
                             interval_batch=16, pin_limit=None)


def default_config(rt):
    """``RunConfig()``: RK4, the 21 x 15 source matrix from 70E, 4S x zwn
    1..7 (6,615 rays), 90 days of 2 h steps: the CLI's default run."""
    return rt.RunConfig()


def readme_config(rt, days=README_DAYS):
    """The README's Usage run: the default source matrix (6,615 rays),
    exact-bound RK45, interval_batch 16, rtol = atol = 1e-6; ``days`` of
    its 90."""
    return rt.RunConfig(integrator="rk45", ttotal=days * DAY)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def cuda_ms(fn, reps):
    """Mean device time of ``fn()`` in ms over ``reps`` runs (CUDA events,
    one warm-up run first)."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def wall_s(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def bound(nbytes, flops, unit=None):
    """The least time for the work: the larger of bytes over the memory
    rate and flops over the peak of ``unit`` (a key of ``PEAK_FLOPS``),
    and which of the two it is. ``flops`` may be a dict {unit: flops} of
    work split between units: their times add."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    if not isinstance(flops, dict):
        flops = {unit: flops}
    t_ops = sum(n / PEAK_FLOPS[u] for u, n in flops.items())
    return dict(bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def cell_of(x, n):
    """``ray_rhs.cuh``'s ``cell_index``: floor(x) held to [0, n - 1], NaN
    to 0, as int64."""
    import torch

    return torch.nan_to_num(torch.floor(x), nan=0.0).clamp(0, n - 1).long()


def sampled_bytes(bg, samples):
    """The bytes of ``bg``'s stack that RHS evaluations at ``samples``
    ((lon, lat, t) a lane each, t a float or per lane) read: each distinct
    row of 48 values they take once. A sample reads its lane's cell
    (``sample_mercator``, a NaN position at cell (0, 0) and a latitude
    past a pole at 0, as ``ray._sample_sanitized`` has it) in its member's
    stack, in the two frames bracketing its time where the stack is timed
    (``lerp_frames``), else in frame 0."""
    import torch
    from rwrt_tpu_torch.models import ray

    f = bg.fields
    w, h = f.shape[-3], f.shape[-2]
    member = bg.member_ids
    timed = ray.timed(bg)
    nt = f.shape[-4] if timed else 1
    keys = []
    for lon, lat, t in samples:
        lon, lat = lon.to(f.dtype), lat.to(f.dtype)
        dead = torch.isnan(lon) | torch.isnan(lat)
        lat = torch.where(dead | (torch.abs(lat) > 0.5 * math.pi), 0.0, lat)
        lon = torch.where(dead, 0.0, lon)
        cell = (cell_of(torch.remainder(lon - bg.lon0, 2 * math.pi) / bg.dx,
                        w) * h + cell_of((lat - bg.lat0) / bg.dy, h))
        m = (torch.zeros_like(cell) if member is None
             else member.long().expand(cell.shape))
        frames = [torch.zeros_like(cell)]
        if timed:
            tf = torch.as_tensor(t, dtype=torch.float64, device=cell.device)
            tf = ((tf - bg.bg_t0) / bg.bg_dt).clamp(0, nt - 1)
            i0 = cell_of(tf, nt).expand(cell.shape)
            frames = [i0, torch.clamp(i0 + 1, max=nt - 1)]
        keys += [(m * nt + i) * (w * h) + cell for i in frames]
    rows = int(torch.unique(torch.cat(keys)).numel())
    return rows * f.shape[-1] * f.element_size()


def same(a, b):
    """Equal to the bit, NaN where NaN."""
    import torch

    return same_nan(a, b) and bool(torch.equal(torch.nan_to_num(a),
                                               torch.nan_to_num(b)))


def same_nan(a, b):
    import torch

    return bool(torch.equal(torch.isnan(a), torch.isnan(b)))


def rel_err(a, b, dim):
    """max |a - b| / max |a| along ``dim``, NaN entries excluded."""
    import torch

    d = torch.nan_to_num(torch.abs(a - b), nan=0.0)
    s = torch.nan_to_num(torch.abs(a), nan=0.0).amax(dim=dim, keepdim=True)
    return float((d / torch.clamp(s, min=1e-300)).max())


def in_turns(run, shape, launch, reps, same_as):
    """Each RK4 or exact kernel instance at one shape: its output held to
    ``same_as`` (a predicate on the output), then its device time in turns
    (TURNS, ``reps`` launches each). Records and prints the times in ms."""
    names = list(dict.fromkeys(TURNS))
    for name in names:
        check(same_as(launch(name)),
              f"{shape}: instance {name} differs from the plain version")
    times = {}
    for name in TURNS:
        times.setdefault(name, []).append(cuda_ms(lambda: launch(name), reps))
    run.turns[shape] = times
    print(f"  {shape}, instances in turns {'/'.join(TURNS)}, bitwise equal "
          "to the plain version: " + ", ".join(
              f"{n} {' / '.join(f'{t:.4f}' for t in ts)} ms"
              for n, ts in times.items()))
    return times


def print_choice(run, shape, chosen, strict=True):
    """The launcher's instance at a shape beside the Lane time of the same
    turns (each instance's best turn); with ``strict``, fails if the choice
    ran slower than Lane there."""
    times = {n: min(ts) for n, ts in run.turns[shape].items()}
    ratio = times[chosen] / times["lane"]
    run.choices[shape] = (chosen, ratio)
    print(f"  {shape}: the launcher takes {chosen}, {ratio:.3f} x lane's "
          f"time ({'slower' if ratio > 1 else 'not slower'} than lane)")
    check(not strict or ratio <= 1.0, f"{shape}: the launcher's {chosen} "
          f"ran {ratio:.3f} x lane's time")


class Run:
    """State shared by the phases: device, backgrounds, seeds, results."""

    def __init__(self, torch, rt):
        self.torch = torch
        self.rt = rt
        self.dev = torch.device("cuda", 0)
        self.u, self.v, self.lat, self.lon = climatology_background()
        rng = np.random.default_rng(0)
        self.slon = rng.uniform(0, 2 * np.pi, N_SOURCES)
        self.slat = rng.uniform(np.radians(-65), np.radians(65),
                                N_SOURCES)
        self.kernels = {}
        self.turns = {}
        self.choices = {}
        #: The plain stage's runs not yet taken: key -> (the call, the
        #: file of its result and ms).
        self.ahead = {}

    def bs(self, dtype):
        return self.rt.prepare(self.u, self.v, self.lat, self.lon,
                               cal_dtype=dtype, device=self.dev)

    def seed_batch(self, dtype):
        """The production run's seed batch: (bs, bg, y0, ug0, vg0)."""
        from rwrt_tpu_torch import tracer

        bs = self.bs(dtype)
        bg = tracer.make_background(bs, 0.0)
        t = self.torch
        y0, ug0, vg0 = tracer.initialize(
            bg, t.as_tensor(self.slon, dtype=dtype, device=self.dev),
            t.as_tensor(self.slat, dtype=dtype, device=self.dev),
            t.arange(1, 8, dtype=dtype, device=self.dev))
        return bs, bg, y0.contiguous(), ug0, vg0

    def entry(self, dtype, matrix=None, state=None):
        """``trace_rays``' compacted entry state (bg, y0, ug0, vg0, idx) for
        the production seeding or, given a RunConfig ``matrix``, its source
        matrix, over a ``dtype`` background; idx the compacted lanes'
        indices in the seed batch. ``state`` (float64 over a float32
        background: mixed precision) widens y0 as ``trace_rays`` does;
        ug0 and vg0 keep the background's dtype."""
        from rwrt_tpu_torch import tracer

        torch = self.torch
        if matrix is None:
            _, bg, y0, ug0, vg0 = self.seed_batch(dtype)
        else:
            m = matrix
            bg = tracer.make_background(self.bs(dtype), m.freq)
            slon, slat = tracer.source_matrix(m.sw_lon, m.sw_lat, m.dlon,
                                              m.dlat, m.nnx, m.nny)
            y0, ug0, vg0 = tracer.initialize(bg, *(
                torch.as_tensor(x, dtype=dtype, device=self.dev)
                for x in (slon, slat, m.zwn_array())))
        idx = tracer.compact_lane_indices(
            torch.isfinite(y0[4]).cpu().numpy())
        take = torch.as_tensor(idx, device=self.dev)
        y0 = y0.index_select(1, take).to(state or dtype).contiguous()
        return (bg, y0, ug0.index_select(0, take),
                vg0.index_select(0, take), idx)

    def run_inputs(self, dtype, cfg=None, matrix=None, state=None):
        """``trace_rays``' entry state for an adaptive run ``cfg`` (default:
        the production run) from the production seeding or ``matrix``'s
        source matrix, as it hands it to ``_dense_run`` or ``_exact_run``:
        the compacted lanes, their (ug0, vg0), h0 and f0 (its entry
        stage, ``tracer.entry_stage``), the padded bounds and the run's
        scalars. Returns (bg, args, kw, idx) with idx the
        compacted lanes' indices in the seed batch, kw the pin-kill of a
        dense run. ``state`` as for ``entry``: the run's scalars, h0 and
        the bounds then take the state's dtype, f0 the background's."""
        from rwrt_tpu_torch import tracer
        from rwrt_tpu_torch.solvers import rk45

        cfg = production_config(self.rt) if cfg is None else cfg
        bg, y0, ug0, vg0, idx = self.entry(dtype, matrix, state)
        sdt = y0.dtype
        rtol = rk45.validate_tol(cfg.rtol, sdt)
        atol = rk45.as_scalar(cfg.atol, sdt)
        min_step = rk45.as_scalar(min(cfg.min_step_factor * cfg.tstep,
                                      cfg.tstep * 1e-3), sdt)
        h0, f0 = tracer.entry_stage(bg, y0, 0.0, rtol, atol)
        bounds_g = tracer.padded_bounds(
            rk45.as_scalar(cfg.tstep, sdt), cfg.nt,
            min(cfg.interval_batch, cfg.nt - 1), sdt, self.dev)
        args = (bg, y0, ug0, vg0, h0, f0, bounds_g, cfg.nt - 1,
                rk45.as_scalar(cfg.cut_off_rad, sdt), rtol, atol, min_step)
        kw = ({} if cfg.pin_limit is None
              else dict(pin_limit=cfg.pin_limit, pin_mwn=cfg.pin_mwn))
        return bg, args, kw, idx


#: The plain stage. A plain run is a host-bound Python loop (the host's
#: dispatch sets its pace; the card is mostly idle), so the slowest ones
#: run PLAIN_WORKERS at a time in worker processes (``python chip_smoke.py
#: --plain``) while this process waits: a phase then takes its plain
#: run's result (``plain_call``) and holds its kernel to it as before.
#: Nothing is timed beside the workers: on an H100 four of them each ran a
#: plain dense group in 1.2-1.4x its time alone (2.8-3.2x the work in the
#: wall time of one), and the dense kernel timed beside three ran 3.0-3.6x
#: slower (``plain_stage_probe.py``).
#: A plain run's ms in the kernels line is the one its worker measured.
PLAIN_WORKERS = 4
PLAIN_TIMEOUT = 900
#: Seconds each plain run of the stage took alone on an H100's host (in
#: this script's runs before the stage), for sharing the runs out among
#: the workers.
PLAIN_SECONDS = {
    "dense_run float32": 98, "dense_run float64": 70,
    "exact_run float32": 93, "exact_run float64": 31,
    "rk4 production float32": 10, "rk4 production float64": 9,
    "rk4 default float32": 26, "mixed rk4 production": 9,
    "mixed rk4 default": 31, "mixed dense_run": 25, "mixed exact_run": 41}


def timed_plain(fn, args, kw):
    """fn(*args, **kw) and its ms between CUDA events around it."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn(*args, **kw)
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def same_tree(a, b):
    """Two argument trees (tuples, named tuples, lists, dicts, tensors,
    scalars, None) equal: tensors of one dtype, shape and device, bitwise
    (NaN where NaN)."""
    import torch

    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        return (isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor)
                and a.dtype == b.dtype and a.shape == b.shape
                and a.device == b.device
                and (same(a, b) if a.is_floating_point()
                     else bool(torch.equal(a, b))))
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(same_tree(a[k], b[k]) for k in a))
    if isinstance(a, (tuple, list)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(same_tree(x, y) for x, y in zip(a, b)))
    return a == b or (a != a and b != b)


def plain_stage(run, jobs):
    """Runs ``jobs`` ((key, seconds expected, the name of a ``tracer``
    function, args, kwargs)) in min(PLAIN_WORKERS, len(jobs)) worker
    processes, shared out longest first, while this process waits; raises
    unless every worker exits 0. Each result waits in a file of the run's
    temporary directory, under its key in ``run.ahead``, for
    ``plain_call``. Returns the wall seconds."""
    torch = run.torch

    folder = Path(run.tmp) / "plain"
    folder.mkdir(exist_ok=True)
    first = len(list(folder.glob("*.in.pt")))
    loads = [[0.0, []] for _ in range(min(PLAIN_WORKERS, len(jobs)))]
    for i, (key, est, fn, args, kw) in sorted(
            enumerate(jobs, first), key=lambda job: -job[1][1]):
        torch.save((fn, args, kw), folder / f"{i}.in.pt")
        load = min(loads, key=lambda w: w[0])
        load[0] += est
        load[1].append(str(i))
        run.ahead[key] = ((fn, args, kw), folder / f"{i}.out.pt")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--plain",
         str(folder), *stems], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for _, stems in loads]
    try:
        for proc in procs:
            out, err = proc.communicate(timeout=PLAIN_TIMEOUT)
            check(proc.returncode == 0, f"a plain worker exited "
                  f"{proc.returncode}:\n{out}\n{err}")
    finally:
        for proc in procs:       # after a failure: stop the others
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return time.perf_counter() - t0


def plain_worker(folder, stems):
    """A plain stage's worker: for each stem, the call in ``<stem>.in.pt``
    timed (``timed_plain``), its result and ms saved to ``<stem>.out.pt``."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from rwrt_tpu_torch import tracer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for stem in stems:
        fn, args, kw = torch.load(folder / f"{stem}.in.pt",
                                  map_location="cuda:0", weights_only=False)
        torch.save(timed_plain(getattr(tracer, fn), args, kw),
                   folder / f"{stem}.out.pt")
    return 0


def plain_call(run, key, fn, *args, **kw):
    """``tracer.<fn>(*args, **kw)`` and its ms: the plain stage's result
    under ``key`` where the stage ran this call on these inputs (bitwise),
    else run here, timed the same way (``timed_plain``)."""
    torch = run.torch
    from rwrt_tpu_torch import tracer

    ahead = run.ahead.pop(key, None)
    if ahead is not None:
        call, path = ahead
        if same_tree(call, (fn, args, kw)):
            out = torch.load(path, map_location=run.dev, weights_only=False)
            path.unlink()
            return out
        print(f"plain {key}: not the plain stage's inputs; run here")
    return timed_plain(getattr(tracer, fn), args, kw)


def dense_run_args(run, dtype):
    """phase_dense_run's unit arguments: the production run's entry state,
    float64 on its first N_SUBSET lanes. Returns (args, kw, idx)."""
    _, args, kw, idx = run.run_inputs(dtype)
    if dtype == run.torch.float64:
        args = lane_subset(args, N_SUBSET)
    return args, kw, idx


def exact_run_args(run, dtype):
    """phase_exact_run's unit arguments: the README run's entry state,
    float64 on its first EXACT_SUBSET lanes over EXACT_DAYS days. Returns
    (args, idx, cfg)."""
    cfg = readme_config(run.rt)
    _, args, _, idx = run.run_inputs(dtype, cfg, cfg)
    if dtype == run.torch.float64:
        n_bounds = int(EXACT_DAYS * DAY / cfg.tstep)
        args = lane_subset(args, EXACT_SUBSET)
        groups = args[6][:n_bounds // args[6].shape[1]]
        args = args[:6] + (groups, n_bounds) + args[8:]
    return args, idx, cfg


def rk4_args(run, name, dtype, state=None):
    """An RK4 unit's arguments (bg, y0, ug0, vg0, dt, nt, cut_off) on the
    entry state of the production seeding (``name`` "production", 30 days;
    float64 on its first N_SUBSET lanes) or of the default run, ``state``
    as for ``Run.entry``. Returns (args, idx, cfg)."""
    from rwrt_tpu_torch.solvers import rk45

    production = name == "production"
    cfg = (rk4_production_config if production else default_config)(run.rt)
    bg, y0, ug0, vg0, idx = run.entry(dtype, None if production else cfg,
                                      state)
    if dtype == run.torch.float64:
        y0, ug0, vg0 = (x[..., :N_SUBSET].contiguous()
                        for x in (y0, ug0, vg0))
    sdt = state or dtype
    return (bg, y0, ug0, vg0, rk45.as_scalar(cfg.tstep, sdt), cfg.nt,
            rk45.as_scalar(cfg.cut_off_rad, sdt)), idx, cfg


def mixed_dense_args(run):
    """phase_mixed_dense's unit arguments (the production run's entry
    state, float64 over the float32 background) and their plain cut: the
    first N_SUBSET lanes over the first MIXED_PLAIN_GROUPS groups. Returns
    (args, kw, idx, cut)."""
    torch = run.torch
    _, args, kw, idx = run.run_inputs(torch.float32, state=torch.float64)
    sub = lane_subset(args, N_SUBSET)
    groups = sub[6][:MIXED_PLAIN_GROUPS]
    return args, kw, idx, sub[:6] + (groups, groups.numel()) + sub[8:]


def mixed_exact_args(run):
    """phase_mixed_exact's unit arguments (the README run over
    MIXED_README_DAYS days, float64 over the float32 background) and their
    plain cut: the first EXACT_SUBSET lanes over EXACT_DAYS days. Returns
    (args, idx, cfg, cut)."""
    torch = run.torch
    cfg = readme_config(run.rt, MIXED_README_DAYS)
    _, args, _, idx = run.run_inputs(torch.float32, cfg, cfg,
                                     state=torch.float64)
    n_bounds = int(EXACT_DAYS * DAY / cfg.tstep)
    sub = lane_subset(args, EXACT_SUBSET)
    sub = sub[:6] + (sub[6][:n_bounds // sub[6].shape[1]], n_bounds) + sub[8:]
    return args, idx, cfg, sub


def phase_plain_ahead(run):
    """The plain stage for the whole-run phases: the plain runs of
    dense_run, rk4, exact_run, mixed_dense, mixed_rk4 and mixed_exact on
    the inputs those phases build (the same functions), in worker
    processes, before any phase times a kernel."""
    torch = run.torch
    f32, f64 = torch.float32, torch.float64
    jobs = []
    for dtype in (f32, f64):
        name = str(dtype)[6:]
        args, kw, _ = dense_run_args(run, dtype)
        jobs.append((f"dense_run {name}", "_dense_run_plain", args, kw))
        args, _, _ = exact_run_args(run, dtype)
        jobs.append((f"exact_run {name}", "_exact_run_plain", args, {}))
        jobs.append((f"rk4 production {name}", "_run_rk4_plain",
                     rk4_args(run, "production", dtype)[0], {}))
    jobs.append(("rk4 default float32", "_run_rk4_plain",
                 rk4_args(run, "default", f32)[0], {}))
    for name in ("production", "default"):
        jobs.append((f"mixed rk4 {name}", "_run_rk4_plain",
                     rk4_args(run, name, f32, f64)[0], {}))
    args, kw, _, cut = mixed_dense_args(run)
    jobs.append(("mixed dense_run", "_dense_run_plain", cut, kw))
    jobs.append(("mixed exact_run", "_exact_run_plain",
                 mixed_exact_args(run)[3], {}))
    wall = plain_stage(run, [(key, PLAIN_SECONDS[key], fn, args, kw)
                             for key, fn, args, kw in jobs])
    print(f"plain stage: {len(jobs)} plain runs in "
          f"{min(PLAIN_WORKERS, len(jobs))} worker processes, {wall:.1f} s "
          f"(each one's ms where its phase prints it)")


def phase_rhs(run):
    torch = run.torch
    from rwrt_tpu_torch.models import ray

    rng = np.random.default_rng(1)
    n = 100_800
    y = np.stack([
        rng.uniform(-1.0, 7.3, n),          # lon < lon0 and > 2*pi
        rng.uniform(-1.65, 1.65, n),        # |lat| > pi/2 and the polar cap
        rng.uniform(0.5, 7.5, n),
        rng.normal(0.0, 40.0, n),           # |ky| >= 100 on a few percent
        rng.uniform(0.5, 2.0, n),
    ])
    for row in (0, 3, 4):                   # NaN lon / ky / amp
        y[row, rng.choice(n, 500, replace=False)] = np.nan
    y[1, :200] = np.pi / 2 - 1e-3           # inside the polar cap
    for dtype, bar in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        _, bg, _, _, _ = run.seed_batch(dtype)
        yt = torch.as_tensor(y, dtype=dtype, device=run.dev).contiguous()
        for gv in (False, True):
            # Through the public wrappers, which must launch the kernel.
            before = ray.LAUNCHES
            if gv:
                dy, ug, vg = ray.rhs_and_gv(bg, yt)
                k = (dy, None, ug, vg)
            else:
                k = (*ray.rhs(bg, yt), None, None)
            check(ray.LAUNCHES == before + 1, "rhs wrapper did not launch")
            p = ray._rhs_core(bg, yt, 0.0, gv)
            torch.cuda.synchronize()
            if not gv:
                check(torch.equal(k[1], p[1]),
                      f"rhs err flags differ ({dtype})")
            check(same_nan(k[0], p[0]), f"rhs NaN pattern differs ({dtype})")
            e = rel_err(p[0], k[0], dim=1)
            if gv:
                for a, b in ((k[2], p[2]), (k[3], p[3])):
                    check(same_nan(a, b), f"rhs_and_gv NaN differs ({dtype})")
                    e = max(e, rel_err(b[None], a[None], dim=1))
            tag = f"{str(dtype)[6:]}{'_gv' if gv else ''}"
            print(f"rhs {tag}: max err / row max {e:.3e} (bar {bar:g})")
            check(e <= bar, f"rhs {tag} error {e} > {bar}")
        if dtype == torch.float32:
            ms = cuda_ms(lambda: ray.rhs(bg, yt), 50)
            alone = launch_parts(lambda: ray.rhs(bg, yt), ("rhs_kernel",),
                                 reps=50).get("rhs_kernel")
            plain = cuda_ms(lambda: ray._rhs_core(bg, yt, 0.0, False), 20)
            # y in, dy and err out, the background rows the lanes sample.
            b = bound(2 * nbytes(yt) + n
                      + sampled_bytes(bg, ((yt[0], yt[1], 0.0),)),
                      n * RHS_FLOPS, "float32")
            kernel_ms = None if alone is None else alone / 1e3
            print(f"rhs time at R={n}: wrapper (ray.rhs: its outputs' "
                  f"allocation, the ctypes call, the launch) {ms:.4f} ms, "
                  f"the kernel alone (torch.profiler) "
                  + ("not seen" if kernel_ms is None
                     else f"{kernel_ms:.4f} ms")
                  + f", plain {plain:.4f} ms, bound {b['bound_ms']:.4f} ms "
                  f"({b['bound_by']})")
            run.kernels["rhs"] = dict(
                max_abs_err=float(torch.nan_to_num(
                    torch.abs(k[0] - p[0]), nan=0.0).max()),
                ms=ms, kernel_ms=kernel_ms, plain_ms=plain, library_ms=None,
                **b)


def _group_pos_diff_deg(a, b):
    """Great-circle distance in degrees between (lon, lat) rows."""
    dlon, dlat = a[0] - b[0], a[1] - b[1]
    h = (dlat / 2).sin() ** 2 + a[1].cos() * b[1].cos() * (dlon / 2).sin() ** 2
    return 2 * h.clamp(0, 1).sqrt().asin() * (180.0 / math.pi)


def phase_dense_group(run):
    torch = run.torch
    from rwrt_tpu_torch.models import ray
    from rwrt_tpu_torch.solvers import rk45
    from rwrt_tpu_torch import tracer

    for dtype in (torch.float64, torch.float32):
        bs, bg, y0, _, _ = run.seed_batch(dtype)
        r = y0.shape[1]
        rhs_fn = ray.RayRHS(bg)
        rtol = rk45.validate_tol(1e-6, dtype)
        atol = rk45.as_scalar(1e-6, dtype)
        min_step = rk45.as_scalar(1e-3 * 2 * HOUR, dtype)
        h0 = tracer.initial_step_sizes(bg, y0, rtol, atol)
        t0 = torch.zeros_like(y0[0])
        f0 = rhs_fn(y0)
        bounds = torch.arange(1, 61, dtype=dtype, device=run.dev) * (2 * HOUR)
        args = (rhs_fn, y0, t0, h0, f0, bounds, rtol, atol, min_step)
        pin = dict(pin_limit=500, pin_mwn=0.0)
        plain_rhs = lambda yy, tt=0.0: ray._rhs_core(bg, yy, tt, False)[0]  # noqa: E731

        def run_kernel():
            return rk45.integrate_group_dense(*args, **pin)

        def run_plain():
            return rk45._integrate_group_dense_plain(
                plain_rhs, *args[1:], 1_000_000, **pin)

        kern, k_s = wall_s(run_kernel)
        plain, p_s = wall_s(run_plain)
        name = str(dtype)[6:]
        print(f"dense_group {name}: R={r}, wall kernel {k_s * 1e3:.1f} ms, "
              f"plain {p_s * 1e3:.1f} ms, trips kernel {int(kern[5])} "
              f"plain {plain[5]}")
        la_same = float((kern[7] == plain[7]).float().mean())
        ka = ~torch.isnan(kern[0][-1, 0])
        pa = ~torch.isnan(plain[0][-1, 0])
        alive_same = float((ka == pa).float().mean())
        both = ka & pa
        dpos = torch.nan_to_num(
            torch.abs(kern[0][:, :2] - plain[0][:, :2]), nan=0.0
        ).amax(dim=(0, 1))[both]
        q = torch.quantile(dpos, torch.tensor([0.5, 0.999], dtype=dpos.dtype,
                                              device=dpos.device))
        end_deg = _group_pos_diff_deg(kern[0][-1, :2, both],
                                      plain[0][-1, :2, both])
        med_deg = float(end_deg.median())
        print(f"  lane_att same {la_same:.5f}, alive same {alive_same:.5f}, "
              f"|dlon|,|dlat| over alive lanes: max {float(dpos.max()):.3e} "
              f"p99.9 {float(q[1]):.3e} median {float(q[0]):.3e} rad, "
              f"group-end median {med_deg:.3e} deg")
        if dtype == torch.float64:
            check(la_same >= 0.999, f"lane_att agreement {la_same} < 0.999")
            check(alive_same >= 0.999, f"alive agreement {alive_same} < 0.999")
            check(float(dpos.max()) <= 1e-7,
                  f"float64 max position difference {float(dpos.max())} > 1e-7")
        else:
            check(med_deg <= 0.01, f"float32 median {med_deg} deg > 0.01")
            ms = cuda_ms(run_kernel, 5)
            plain_ms = p_s * 1e3  # the checked run's wall: host-bound
            # State and bounds in; rows, carry, flags and attempts out.
            frozen = torch.isnan(y0.mean(dim=0))
            rows = int((torch.isfinite(kern[0][:, 0]) & ~frozen).sum())
            b = bound(nbytes(y0, t0, h0, f0, bounds, bg.fields, kern[0],
                             *kern[1:5], kern[7], kern[8], kern[9]),
                      int(kern[7].sum()) * ATTEMPT_FLOPS + rows * ROW_FLOPS,
                      "float32")
            print(f"  float32 time: kernel {ms:.3f} ms (CUDA events), "
                  f"plain {plain_ms:.1f} ms (wall), bound "
                  f"{b['bound_ms']:.4f} ms ({b['bound_by']})")
            run.kernels["dense_group"] = dict(
                max_abs_err=float(dpos.max()), ms=ms, plain_ms=plain_ms,
                library_ms=None, **b)
    dense_group_mixed(run)


def dense_group_mixed(run):
    """The single-group dense kernel's mixed instance (a float64 state over
    the float32 background) on the seed batch's 60 bounds with pin-kill,
    against the plain loop: every output bitwise."""
    torch = run.torch
    from rwrt_tpu_torch.models import ray
    from rwrt_tpu_torch.solvers import rk45
    from rwrt_tpu_torch import tracer

    f64 = torch.float64
    _, bg, y0, _, _ = run.seed_batch(torch.float32)
    y0 = y0.to(f64)
    rtol = rk45.validate_tol(1e-6, f64)
    min_step = 1e-3 * 2 * HOUR
    h0 = tracer.initial_step_sizes(bg, y0, rtol, 1e-6)
    t0 = torch.zeros_like(h0)
    f0 = ray.RayRHS(bg)(y0)
    bounds = torch.arange(1, 61, dtype=f64, device=run.dev) * (2 * HOUR)
    args = (y0, t0, h0, f0, bounds, rtol, 1e-6, min_step)
    pin = dict(pin_limit=500, pin_mwn=0.0)

    def plain_rhs(yy, tt=0.0):
        return ray._rhs_core(bg, yy, tt, False)[0]

    def run_kernel():
        return rk45.integrate_group_dense(ray.RayRHS(bg), *args, **pin)

    def run_plain():
        return rk45._integrate_group_dense_plain(plain_rhs, *args, 1_000_000,
                                                 **pin)

    before = rk45.LAUNCHES
    kern = run_kernel()
    check(rk45.LAUNCHES == before + 1, "mixed dense_group did not launch")
    plain, p_s = wall_s(run_plain)
    for i in (0, 1, 2, 3, 4):
        check(kern[i].dtype == plain[i].dtype and same(kern[i], plain[i]),
              f"mixed dense_group: output {i} differs from the plain loop")
    for i in (7, 8, 9):
        check(torch.equal(kern[i], plain[i]),
              f"mixed dense_group: output {i} differs from the plain loop")
    check(int(kern[5]) == plain[5], "mixed dense_group: trips differ")
    ms = cuda_ms(run_kernel, 5)
    frozen = torch.isnan(y0.mean(dim=0))
    rows = int((torch.isfinite(kern[0][:, 0]) & ~frozen).sum())
    attempts = int(kern[7].sum())
    flops = {u: attempts * n for u, n in MIX_ATTEMPT_FLOPS.items()}
    flops["float64"] += rows * ROW_FLOPS
    b = bound(nbytes(y0, t0, h0, f0, bounds, bg.fields, kern[0], *kern[1:5],
                     kern[7], kern[8], kern[9]), flops)
    print(f"dense_group mixed: R={y0.shape[1]}, 60 bounds, bitwise equal to "
          f"the plain loop (rows, carry, trips, attempts, flags); step "
          f"attempts {attempts}; kernel {ms:.3f} ms (CUDA events), plain "
          f"{p_s * 1e3:.1f} ms (wall), bound {b['bound_ms']:.4f} ms "
          f"({b['bound_by']})")
    run.kernels["dense_group_mix"] = dict(
        max_abs_err=0.0, ms=ms, plain_ms=p_s * 1e3, library_ms=None, **b)


def dense_run_bound(args, out, dtype):
    """Bytes: the entry state, bounds and background in, every output out;
    flops: this run's step attempts, and the rows it keeps, each with its
    interpolant, kill test and (ug, vg) sample. ``dtype`` "mixed": the
    flops split as MIX_ATTEMPT_FLOPS, the rows' in float64."""
    bg, y0, ug0, vg0, h0, f0, bounds_g = args[:7]
    rows = int(out.ys[1:, 0].isfinite().sum())
    attempts = int(out.lane_att.sum())
    if dtype == "mixed":
        flops = {u: attempts * n for u, n in MIX_ATTEMPT_FLOPS.items()}
        flops["float64"] += rows * (ROW_FLOPS + CASCADE_FLOPS)
    else:
        flops = {str(dtype)[6:]: attempts * ATTEMPT_FLOPS
                 + rows * (ROW_FLOPS + CASCADE_FLOPS)}
    return bound(nbytes(bg.fields, y0, ug0, vg0, h0, f0, bounds_g, out.ys,
                        out.ugs, out.vgs, out.lane_att, out.trunc,
                        *out.carry), flops)


def lane_subset(args, n):
    """``_dense_run``'s arguments cut to their first n lanes."""
    r = args[1].shape[1]
    return tuple(a[..., :n].contiguous() if hasattr(a, "shape") and a.ndim
                 and a.shape[-1] == r else a for a in args)


def dense_registers(key, variant):
    """Registers and spill bytes (stores, loads) of the whole-run dense
    kernel's instance for the (state, field) dtypes ``key`` and background
    ``variant``, from the build's ``nvcc.log`` (``-Xptxas -v``)."""
    import torch
    from rwrt_tpu_torch.kernels import build

    code = {torch.float32: "f", torch.float64: "d"}
    tag = (f"dense_kernelI{code[key[0]]}{code[key[1]]}Lb1E"
           f"Lb{int(variant == '_time')}E")
    log = (build.BUILD_ROOT / build.source_hash() / "nvcc.log").read_text()
    name, regs, spill = None, None, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            continue
        if name is None or tag not in name:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            regs = int(m.group(1))
    check(regs is not None, f"no register report for {tag} in nvcc.log")
    return regs, spill


def dense_report(run, what, args, kw, out, floor=True):
    """Print a whole-run dense launch's warp occupancy (lanes in launch
    order, one thread to a lane's end; and under the repacking kernel's
    schedule at its grid), the instance's registers and spills, and, with
    ``floor``, its chain floor: its longest lane alone (R = 1), bitwise
    the full run's lane. Returns {occupancy, repacked_occupancy, registers,
    chain_floor_ms}."""
    torch = run.torch
    from rwrt_tpu_torch import kernels, tracer
    from rwrt_tpu_torch.models import ray

    from profile_main_path import repacked_occupancy, warp_occupancy

    bg, y0 = args[0], args[1]
    key = kernels.state_key(y0, bg.fields)
    variant = ray.kernel_background(bg, y0.device, key[1], y0.shape[1])[0]
    blocks, block = tracer.dense_grid(key, variant)
    every, trigger = tracer.DENSE_SCHEDULE[key]
    before = warp_occupancy(out.lane_att)
    after, issued = repacked_occupancy(out.lane_att, block, blocks, every,
                                       trigger)
    regs, spill = dense_registers(key, variant)
    rec = dict(occupancy=before, repacked_occupancy=after, registers=regs,
               spill=spill)
    msg = (f"  {what}: warp occupancy {before:.4f} in launch order, "
           f"{after:.4f} repacked ({blocks} blocks x {block} threads, a "
           f"repack after {every} iterations or {trigger} lanes left; "
           f"busiest block "
           f"{int(issued.max())} warp-iterations, mean "
           f"{float(issued.mean()):.1f}); kernel dense_kernel"
           f"{variant or '_static'} "
           f"{'mixed' if key[0] != key[1] else str(key[0])[6:]} {regs} "
           f"registers, spill stores/loads {spill} bytes")
    if floor:
        trips = out.lane_att.sum(dim=0)
        lane = int(trips.argmax())
        take = torch.tensor([lane], device=y0.device)
        one = lane_pick(args, take)
        alone = tracer._dense_run(*one, **kw)
        for n in ("ys", "ugs", "vgs", "lane_att", "trunc"):
            check(same(getattr(alone, n),
                       getattr(out, n).index_select(-1, take)),
                  f"{what}: the longest lane alone differs from the full "
                  f"run's ({n})")
        ms = cuda_ms(lambda: tracer._dense_run(*one, **kw), 3)
        rec["chain_floor_ms"] = ms
        msg += (f"; chain floor {ms:.3f} ms (lane {lane} alone, "
                f"{int(trips[lane])} trips, {ms * 1e3 / int(trips[lane]):.3f}"
                " us per trip)")
    print(msg)
    return rec


def phase_dense_run(run):
    torch = run.torch
    from rwrt_tpu_torch import tracer

    def equal(k, p, what):
        for name in ("ys", "ugs", "vgs", "lane_att", "trunc"):
            check(same(getattr(k, name), getattr(p, name)),
                  f"dense_run {what}: {name} differs from the plain run")
        for a, b in zip(k.carry, p.carry):
            check(same(a, b), f"dense_run {what}: carry differs")

    for dtype in (torch.float32, torch.float64):
        name = str(dtype)[6:]
        # float64: the first N_SUBSET lanes (lanes are independent).
        args, kw, idx = dense_run_args(run, dtype)
        r = args[1].shape[1]
        before = tracer.LAUNCHES
        kern = tracer._dense_run(*args, **kw)
        check(tracer.LAUNCHES == before + 1, "dense_run did not launch once")
        ms = cuda_ms(lambda: tracer._dense_run(*args, **kw), 5)
        plain, plain_ms = plain_call(run, f"dense_run {name}",
                                     "_dense_run_plain", *args, **kw)
        equal(kern, plain, f"{name}, {r} lanes")
        b = dense_run_bound(args, kern, dtype)
        trips = kern.lane_att.sum(dim=0)
        print(f"dense_run {name}: R={r}, {kern.ys.shape[0] - 1} bounds in "
              f"{kern.lane_att.shape[0]} groups, bitwise equal to the plain "
              f"run (rows, ug, vg, lane_att, trunc, carry); kernel "
              f"{ms:.3f} ms (CUDA events), plain {plain_ms:.1f} ms, bound "
              f"{b['bound_ms']:.4f} ms ({b['bound_by']}); step attempts "
              f"{int(kern.lane_att.sum())}, max trips per group "
              f"{kern.lane_att.amax(dim=1).tolist()}, longest lane "
              f"{int(trips.max())} trips in all, truncated lane-groups "
              f"{int(kern.trunc.sum())}")
        rec = dense_report(run, f"dense_run {name}", args, kw, kern,
                           floor=False)
        if dtype == torch.float32:
            err = max(float(torch.nan_to_num(torch.abs(k - p), nan=0.0).max())
                      for k, p in ((kern.ys, plain.ys), (kern.ugs, plain.ugs),
                                   (kern.vgs, plain.vgs)))
            run.kernels["dense_run"] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
                **b)
            run.dense_run = (idx, kern)
            run.dense_args = (args, kw, rec)
            # The first N_SUBSET lanes alone give the full run's rows.
            part = tracer._dense_run(*lane_subset(args, N_SUBSET), **kw)
            for n in ("ys", "ugs", "vgs", "lane_att", "trunc"):
                check(same(getattr(part, n),
                           getattr(kern, n)[..., :N_SUBSET].contiguous()),
                      f"dense_run: the first {N_SUBSET} lanes' {n} differ "
                      "from the full run's")
            print(f"  the first {N_SUBSET} lanes alone: bitwise equal to "
                  "the full run's")


def phase_dense_lone_lane(run):
    """The production run's longest lane alone (R = 1) through the
    whole-run kernel: bitwise the full run's lane; its time is the chain
    floor of the dense_run phase's launch, recorded beside its bound."""
    args, kw, rec = run.dense_args
    _, kern = run.dense_run
    rec.update(dense_report(run, "dense_lone_lane float32", args, kw, kern))
    k = run.kernels["dense_run"]
    k["chain_floor_ms"] = rec["chain_floor_ms"]
    print(f"dense_lone_lane: chain floor {k['chain_floor_ms']:.3f} ms, "
          f"kernel {k['ms']:.3f} ms ({k['ms'] / k['chain_floor_ms']:.2f} x "
          f"the floor), bound {k['bound_ms']:.4f} ms ({k['bound_by']})")


def phase_main_path(run):
    torch = run.torch
    from rwrt_tpu_torch.models import ray
    from rwrt_tpu_torch import tracer
    from rwrt_tpu_torch.ops import spectral_sample as spec
    from rwrt_tpu_torch.solvers import rk45

    cfg = production_config(run.rt)
    bs = run.bs(torch.float32)
    sbg = spec.fit_spectral(bs)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()

    stats = {}
    ray.LAUNCHES = rk45.LAUNCHES = tracer.LAUNCHES = spec.LAUNCHES = 0
    rk45.EXACT_LAUNCHES = tracer.RK4_LAUNCHES = tracer.EXACT_LAUNCHES = 0
    tracer.ENTRY_LAUNCHES = 0
    t0 = time.perf_counter()
    traj = run.rt.trace_rays(bs, cfg, source_lon=run.slon,
                             source_lat=run.slat, stats=stats)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"rhs": ray.LAUNCHES, "dense_group": rk45.LAUNCHES,
                "dense_run": tracer.LAUNCHES, "spectral": spec.LAUNCHES,
                "entry": tracer.ENTRY_LAUNCHES}
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
    attempts = int(stats["lane_att"].sum())
    check(launches["spectral"] == 0, "trace_rays launched the spectral kernel")
    check(launches["dense_run"] == 1,
          f"trace_rays made {launches['dense_run']} whole-run launches, not 1")
    check(launches["dense_group"] == 0,
          "trace_rays launched the single-group kernel")
    check(launches["entry"] == 1 and launches["rhs"] == 0,
          f"trace_rays' set-up made {launches['entry']} entry-stage and "
          f"{launches['rhs']} RHS launches, not 1 and 0")
    check(rk45.EXACT_LAUNCHES == tracer.RK4_LAUNCHES
          == tracer.EXACT_LAUNCHES == 0,
          "the dense trace_rays launched an RK4 or exact kernel")
    check(attempts == DENSE_ATTEMPTS,
          f"{attempts} step attempts, not {DENSE_ATTEMPTS}")
    # chip_smoke's own sampler stage after the tracer: the spectral fit of
    # the same background at the day-10 positions the tracer emitted. Its
    # counter is read separately: trace_rays never calls the sampler.
    lon10, lat10 = traj.lon[120].reshape(-1), traj.lat[120].reshape(-1)
    fin = torch.isfinite(lon10) & torch.isfinite(lat10)
    pos = (lon10[fin].contiguous(), lat10[fin].contiguous())
    spec.LAUNCHES = 0
    samples = spec.sample_spectral_cuda(sbg, *pos)
    torch.cuda.synchronize()
    launches["spectral"] = spec.LAUNCHES

    n_rays = 3 * N_SOURCES * 7
    nt = 12 * N_DAYS + 1
    for k in traj._fields:
        a = getattr(traj, k)
        check(tuple(a.shape) == (nt, 3, N_SOURCES, 7),
              f"{k} shape {tuple(a.shape)}")
    alive_end = torch.isfinite(traj.ky[-1])
    for k in traj._fields:
        check(bool(torch.isfinite(getattr(traj, k)[-1][alive_end]).all()),
              f"non-finite {k} on a lane alive at day 30")
    check(bool(torch.isfinite(samples).all()), "non-finite spectral sample")
    for k in ("entry", "dense_run", "spectral"):
        check(launches[k] > 0, f"{k} kernel was not launched")
    # The dense_run phase ran the kernel on this run's entry state.
    idx, kern = run.dense_run
    flat = {k: getattr(traj, k).reshape(nt, -1)[:, idx]
            for k in traj._fields}
    for k, row in (("lon", 0), ("lat", 1), ("kx", 2), ("ky", 3), ("amp", 4)):
        check(same(flat[k], kern.ys[:, row]),
              f"trace_rays {k} differs from the dense_run phase's rows")
    check(same(flat["ug"], kern.ugs) and same(flat["vg"], kern.vgs),
          "trace_rays (ug, vg) differ from the dense_run phase's")
    alive = {d: float(torch.isfinite(traj.ky[12 * d]).float().mean())
             for d in (10, 20, 30) if 12 * d < nt}
    rate = n_rays * (nt - 1) / wall
    print(f"main_path ray-steps/s {rate:.1f}")
    print(f"main_path: {n_rays} rays x {N_DAYS} days, wall {wall:.3f} s, "
          f"alive fraction by day {alive}, step attempts {attempts}, peak "
          f"device memory {peak:.1f} MiB above the prepared state; rows "
          f"bitwise equal to the dense_run phase's")
    run.main_wall = wall
    from profile_main_path import warp_occupancy

    args, kw, rec = run.dense_args
    check(torch.equal(stats["lane_att"], kern.lane_att),
          "main_path: trace_rays' attempts differ from the dense_run phase's")
    key = (torch.float32, torch.float32)
    blocks, block = tracer.dense_grid(key)
    every, trigger = tracer.DENSE_SCHEDULE[key]
    print(f"main_path: one launch of the repacking kernel ({blocks} blocks "
          f"x {block} threads, a repack after {every} iterations or "
          f"{trigger} lanes left); warp occupancy before the repacking "
          f"(launch order) "
          f"{warp_occupancy(stats['lane_att']):.4f}, after "
          f"{rec['repacked_occupancy']:.4f}; chain floor "
          f"{rec['chain_floor_ms']:.3f} ms")
    print(f"launches: trace_rays entry {launches['entry']}, rhs "
          f"{launches['rhs']}, dense_run {launches['dense_run']}, "
          f"dense_group {launches['dense_group']}; "
          f"sampler stage after it: spectral {launches['spectral']} at "
          f"{pos[0].shape[0]} day-10 points")
    run.launches = launches
    run.day10 = pos
    run.main_traj, run.main_att = traj, stats["lane_att"]


#: Flops of the entry stage a lane beyond its two RHS evaluations, counted
#: from csrc/entry.cu: the scale (10), the three norms' quotients and
#: squares (40), h0 (4), y1 (10), f1 - f0 (5), d2 (1), fmax, h1 and its
#: pow (4), the both-small rule (3), min(100 h0, h1) (2).
ENTRY_FLOPS = 2 * RHS_FLOPS + 79
#: Timed launches of the entry stage (CUDA events).
ENTRY_REPS = 50


def entry_record(run, name, bg, y0, t0, samples_flops=0, timed=False):
    """The entry stage on one entry state: ``tracer.entry_stage`` (one
    launch) bitwise against its plain route on the card, at ``t0`` (a
    float or per-lane times); its wrapper timed, and with ``timed`` (the
    kernels line's records) the kernel alone (torch.profiler) and the
    plain route too; its bound: y0 (and per-lane t0, the member map) in,
    f0 and h0 out, and the background rows its two evaluations sample
    (``sampled_bytes``); two RHS evaluations and the step arithmetic a
    lane (each sample's time blend, ``samples_flops``, twice)."""
    torch = run.torch
    from rwrt_tpu_torch import tracer
    from rwrt_tpu_torch.models import ray
    from rwrt_tpu_torch.solvers import rk45

    sdt = y0.dtype
    rtol, atol = rk45.validate_tol(1e-6, sdt), rk45.as_scalar(1e-6, sdt)
    before = (tracer.ENTRY_LAUNCHES, ray.LAUNCHES)
    h, f = tracer.entry_stage(bg, y0, t0, rtol, atol)
    check((tracer.ENTRY_LAUNCHES, ray.LAUNCHES) == (before[0] + 1,
                                                    before[1]),
          f"{name}: entry_stage did not make one launch and no RHS launch")
    ph, pf = tracer._entry_stage_plain(bg, y0, t0, rtol, atol)
    torch.cuda.synchronize()
    check(h.dtype == sdt and f.dtype == bg.fields.dtype,
          f"{name}: dtypes {h.dtype}, {f.dtype}")
    check(same(h, ph) and same(f, pf),
          f"{name}: h0 or f0 differs from the plain route")
    check(bool(torch.isfinite(h).any()), f"{name}: no finite h0")
    err = max(float(torch.nan_to_num(torch.abs(a.double() - b.double()),
                                     nan=0.0).max()) for a, b in ((h, ph),
                                                                  (f, pf)))
    r = y0.shape[1]

    def kernel():
        return tracer.entry_stage(bg, y0, t0, rtol, atol)

    ms = cuda_ms(kernel, ENTRY_REPS)
    alone_us = plain_ms = None
    if timed:
        alone_us = launch_parts(kernel, ("entry_kernel",),
                                reps=ENTRY_REPS).get("entry_kernel")
        plain_ms = cuda_ms(lambda: tracer._entry_stage_plain(
            bg, y0, t0, rtol, atol), 10)
    # The second evaluation's position and time, as the kernel forms them.
    y1 = y0 + h * f.to(sdt)
    read = sampled_bytes(bg, ((y0[0], y0[1], t0), (y1[0], y1[1], t0 + h)))
    small = nbytes(y0, h, f) + (nbytes(t0) if torch.is_tensor(t0) else 0) + (
        0 if bg.member_ids is None else nbytes(bg.member_ids))
    b = bound(small + read, r * (ENTRY_FLOPS + 2 * samples_flops),
              str(bg.fields.dtype).split(".")[-1])
    kernel_ms = None if alone_us is None else alone_us / 1e3
    print(f"{name}: {r} lanes, h0 and f0 bitwise the plain route's; "
          f"wrapper {ms:.4f} ms"
          + ("" if not timed else
             ", the kernel alone (torch.profiler) "
             + ("not seen" if kernel_ms is None else f"{kernel_ms:.4f} ms")
             + f", plain {plain_ms:.4f} ms")
          + f"; bound {b['bound_ms']:.5f} ms ({b['bound_by']}; "
          f"{read / 1e6:.3f} MB of background rows sampled of "
          f"{nbytes(bg.fields) / 1e6:.3f} MB, {small / 1e6:.3f} MB of "
          "state in and out)")
    return dict(max_abs_err=err, ms=ms, kernel_ms=kernel_ms,
                plain_ms=plain_ms, library_ms=None, **b)


def phase_entry(run):
    """The adaptive runs' entry stage (``tracer.entry_stage``, one launch
    of ``csrc/entry.cu``) on the production run's entry state (the 60,784
    compacted lanes, float32) at t = 0, as main_path ran it, and at
    per-lane times; in float64 and mixed precision on the same seeding;
    each bitwise against the plain route on the card. The float32 record
    is the kernels line's ``entry``."""
    torch = run.torch
    rng = np.random.default_rng(5)
    for name, dtype, state in (("float32", torch.float32, None),
                               ("mixed", torch.float32, torch.float64),
                               ("float64", torch.float64, None)):
        bg, y0, _, _, _ = run.entry(dtype, state=state)
        rec = entry_record(run, f"entry {name}", bg, y0, 0.0,
                           timed=name == "float32")
        if name == "float32":
            run.kernels["entry"] = rec
            t = torch.as_tensor(rng.uniform(0.0, N_DAYS * DAY, y0.shape[1]),
                                dtype=y0.dtype, device=run.dev)
            entry_record(run, "entry float32, per-lane times", bg, y0, t)


def phase_time_entry(run):
    """The entry stage's time instance on the time_main_path run's entry
    state (the lanes it compacted over the TV_DAYS-day daily frames) at
    t = 0, as that run took it, and at per-lane times over the frames and
    past both ends; in mixed precision on the same frames; bitwise against
    the plain route on the card. The first record is the kernels line's
    ``entry_time``."""
    torch = run.torch
    bg, y0 = run.tv_entry
    tsf = time_sample_flops(bg)
    run.kernels["entry_time"] = entry_record(run, "time_entry float32", bg,
                                             y0, 0.0, tsf, timed=True)
    rng = np.random.default_rng(6)
    t = rng.uniform(-2.0 * DAY, (TV_DAYS + 3) * DAY, y0.shape[1])
    for name, y in (("float32", y0), ("mixed", y0.double())):
        entry_record(run, f"time_entry {name}, per-lane times", bg, y,
                     torch.as_tensor(t, dtype=y.dtype, device=run.dev), tsf)


#: The spectral phase's operand cases: (coefficient dtype, matmul_dtype)
#: by name, each over the production fit; float32 operands over float32
#: coefficients and float64 ones over either take the None route (no
#: rounding) and are held to it bitwise.
SPECTRAL_F8 = ("float8_e4m3fn", "float8_e5m2", "float8_e4m3fnuz",
               "float8_e5m2fnuz")
SPECTRAL_CASES = (
    ("float64", None), ("float64", "bfloat16"), ("float64", "float16"),
    ("float64", "float32"), *(("float64", f) for f in SPECTRAL_F8),
    ("float32", None), ("float32", "bfloat16"), ("float32", "float16"),
    *(("float32", f) for f in SPECTRAL_F8))
#: Values in the sweep of the kernel's operand rounding (2^24 a dtype).
ROUND_SWEEP = 1 << 24


def spectral_err(k, p):
    """The kernel ``k`` against the plain ``p`` ((R, C)): raises unless
    their non-finite positions (NaN, +inf, -inf) are equal; returns the
    largest |k - p| over each channel's max |p|, over the finite values."""
    import torch

    check(torch.equal(torch.isnan(k), torch.isnan(p)),
          "spectral NaN positions differ")
    check(torch.equal(torch.isinf(k), torch.isinf(p))
          and torch.equal(k[torch.isinf(k)], p[torch.isinf(p)]),
          "spectral inf positions differ")
    fin = torch.isfinite(p)
    scale = torch.where(fin, p.abs(), 0.0).amax(dim=0, keepdim=True)
    d = torch.where(fin, (k - p).abs(), 0.0)
    return float(torch.where(d == 0, 0.0, d / scale).max())


def spectral_bound(args, flop, dtype, mm):
    """The bound of one spectral case: its bytes, and its flops over the
    card's tensor-core peak for its operand type, not the MMA the kernel
    runs: DMMA for every case over float64 coefficients (float64 sums);
    over float32 ones 3xTF32 (three TF32 products) with no rounding, fp8
    for float8_e4m3fn and float8_e5m2, fp16 / bf16 for float16, bfloat16
    and the fnuz float8 types (no hardware format)."""
    if dtype == "float64":
        return bound(nbytes(*args), flop, "fp64_tc")
    if mm is None:
        return bound(nbytes(*args), 3 * flop, "tf32")
    return bound(nbytes(*args), flop, "fp8" if mm in (
        "float8_e4m3fn", "float8_e5m2") else "fp16")


def cast_counts(torch, spec, coeffs, mm):
    """Per channel, the coefficients the cast to ``mm`` turned to 0, to
    +-inf and to NaN."""
    r = spec.round_operands(coeffs, mm).reshape(-1, coeffs.shape[-1])
    c = coeffs.reshape(r.shape)
    return {"zero": ((r == 0) & (c != 0)).sum(0).tolist(),
            "inf": torch.isinf(r).sum(0).tolist(),
            "nan": torch.isnan(r).sum(0).tolist()}


def round_sweep(torch, dev, dtype):
    """ROUND_SWEEP values in [-1, 1] (``dtype``): uniform; log-uniform
    magnitudes down past every operand format's subnormals; ties of every
    format (odd multiples of 2^-k, 1 <= k <= 40) and their neighbours one
    ulp to each side; signed zeros."""
    g = torch.Generator(device=dev).manual_seed(17)
    n = ROUND_SWEEP // 8
    f64 = torch.float64
    u = torch.rand(n, device=dev, dtype=f64, generator=g) * 2 - 1
    sign = torch.where(u < 0, -1.0, 1.0)
    mag = sign * torch.exp2(-40 * torch.rand(n, device=dev, dtype=f64,
                                             generator=g))
    k = torch.randint(1, 41, (n,), device=dev, generator=g).to(f64)
    odd = 2 * torch.floor(torch.rand(n, device=dev, dtype=f64, generator=g)
                          * torch.exp2(k - 1)) + 1
    ties = (sign * odd * torch.exp2(-k)).to(dtype)
    up = torch.nextafter(ties, torch.full_like(ties, 2.0))
    down = torch.nextafter(ties, torch.full_like(ties, -2.0))
    x = torch.cat([u.to(dtype), mag.to(dtype), ties, -ties, up, down,
                   -up, -down])
    x[:2] = torch.tensor([0.0, -0.0], dtype=dtype, device=dev)
    return x


def phase_spectral(run):
    torch = run.torch
    from rwrt_tpu_torch.ops import spectral_sample as spec

    lon, lat = run.day10
    extra_lon = torch.tensor([0.3, float("nan"), 1.0], device=run.dev)
    extra_lat = torch.tensor([2.0, 0.1, -1.7], device=run.dev)
    run.kernels["spectral"] = dict(cases=[])
    fits = {}
    for name, mm_name in SPECTRAL_CASES:
        dtype = getattr(torch, name)
        mm = None if mm_name is None else getattr(torch, mm_name)
        bar = 1e-12 if name == "float64" else 1e-5
        if name not in fits:
            fits[name] = spec.fit_spectral(run.bs(dtype))
        sbg = fits[name]
        check(tuple(sbg.coeffs.shape) == (145, 73, 18),
              f"coefficients {tuple(sbg.coeffs.shape)}")
        lo = torch.cat([lon.to(dtype), extra_lon.to(dtype)])
        la = torch.cat([lat.to(dtype), extra_lat.to(dtype)])
        tag = name + ("" if mm is None else "_" + mm_name)
        before = spec.LAUNCHES
        k = spec.sample_spectral_cuda(sbg, lo, la, matmul_dtype=mm)
        p = spec.sample_spectral(sbg, lo, la, matmul_dtype=mm)
        k2 = spec.sample_spectral_cuda(sbg, lo, la, matmul_dtype=mm)
        torch.cuda.synchronize()
        check(spec.LAUNCHES == before + 2,
              f"spectral {tag}: the kernel did not launch")
        check(bool(torch.isnan(k[-3:]).all()), "spectral NaN rows missing")
        check(same(k, k2), f"spectral {tag}: two launches differ")
        e = spectral_err(k, p)
        if mm is None:
            # The operand dtypes at least as wide as the coefficients:
            # the same launch, bitwise.
            for wide in {dtype, torch.float64}:
                check(same(k, spec.sample_spectral_cuda(
                    sbg, lo, la, matmul_dtype=wide)),
                    f"spectral {tag}: matmul_dtype={wide} is not None's")
        # The kernel alone, on operands the wrapper would prepare.
        packed = spec.pack_coeffs(sbg.coeffs, mm)
        tht = (la - sbg.lat0).contiguous()
        out = torch.empty_like(k)
        kern = cuda_ms(lambda: spec.launch_kernel(
            packed, lo, la, tht, sbg.coeffs.shape, mm, out), 20)
        check(same(out, k), f"spectral {tag}: the kernel alone differs")
        ms = cuda_ms(lambda: spec.sample_spectral_cuda(
            sbg, lo, la, matmul_dtype=mm), 20)
        plain = cuda_ms(lambda: spec.sample_spectral(
            sbg, lo, la, matmul_dtype=mm), 5)
        # The library call: the product alone, on the rounded basis and
        # coefficients in the operand dtype (bf16 for float8, which
        # torch.matmul does not take).
        mp, nl, nc = sbg.coeffs.shape
        lib = (dtype if mm is None else torch.bfloat16
               if mm_name.startswith("float8") else mm)
        basis = spec.round_operands(
            spec._basis_lon(lo, (mp - 1) // 2), mm).to(lib)
        dflat = spec.round_operands(sbg.coeffs, mm).reshape(
            mp, nl * nc).to(lib)
        library = cuda_ms(lambda: torch.matmul(basis, dflat), 20)
        flop = 2.0 * lo.shape[0] * math.prod(sbg.coeffs.shape)
        b = spectral_bound((lo, la, sbg.coeffs, k), flop, name, mm_name)
        bad = int((~torch.isfinite(k)).sum())
        print(f"spectral {tag}: R={lo.shape[0]}, max err / channel max "
              f"{e:.3e} (bar {bar:g}), non-finite {bad} of {k.numel()} "
              f"(the plain version's positions), kernel alone {kern:.4f} "
              f"ms ({flop / kern * 1e-9:.1f} TFLOP/s), "
              f"wrapper {ms:.4f} ms, plain {plain:.4f} ms, library "
              f"torch.matmul (R, Mp) @ (Mp, L*C) in {str(lib)[6:]} "
              f"{library:.4f} ms; bound {b['bound_ms']:.4f} ms "
              f"({b['bound_by']})")
        if mm is not None:
            print(f"  per channel, coefficients the cast made 0 / inf / "
                  f"NaN: {cast_counts(torch, spec, sbg.coeffs, mm)}")
        check(e <= bar, f"spectral {tag} error {e} > {bar}")
        record = dict(max_abs_err=float(torch.where(
            torch.isfinite(p), (k - p).abs(), 0.0).max()),
            ms=ms, kernel_ms=kern, plain_ms=plain, library_ms=library,
            **b)
        run.kernels["spectral"]["cases"].append(
            dict(coefficients=name, matmul_dtype=mm_name, **record))
        if tag == "float32":
            # The main path's case (float32, no rounding): the kernels
            # line's own numbers.
            run.kernels["spectral"].update(record)
    # The kernel's operand rounding (the device function its prologue
    # rounds the basis with), bitwise the plain round_operands.
    swept = 0
    for dtype in (torch.float32, torch.float64):
        x = round_sweep(torch, run.dev, dtype)
        for mm in spec.OPERAND_DTYPES:
            got = spec.round_on_card(x, mm)
            want = spec.round_operands(x, mm)
            ints = torch.int32 if dtype == torch.float32 else torch.int64
            nan = torch.isnan(want)
            check(torch.equal(torch.isnan(got), nan) and torch.equal(
                torch.where(nan, 0, got).view(ints),
                torch.where(nan, 0, want).view(ints)),
                f"the kernel's rounding of {dtype} to {mm} differs from "
                "round_operands")
            swept += x.numel()
    print(f"spectral: the kernel's operand rounding bitwise round_operands "
          f"on {x.numel():,} values in [-1, 1] a source dtype (float32, "
          f"float64) x {len(spec.OPERAND_DTYPES)} operand dtypes "
          f"({swept:,} in all)")


def rk4_bound(bg, y0, ug0, vg0, out, dtype):
    """Bytes: the entry state and background in, the rows out; flops: the
    steps of the lanes alive after them (a dead lane's arithmetic is not
    needed); ``dtype`` "mixed" splits them as MIX_RK4_STEP_FLOPS. A step's
    five samples (four evaluations and (ug, vg)) each add
    ``time_sample_flops(bg)`` in the background's type."""
    live_steps = int(out[0][1:, 0].isfinite().sum())
    flops = ({u: live_steps * n for u, n in MIX_RK4_STEP_FLOPS.items()}
             if dtype == "mixed" else
             {str(dtype)[6:]: live_steps * RK4_STEP_FLOPS})
    field = str(bg.fields.dtype)[6:]
    flops[field] = (flops.get(field, 0)
                    + 5 * live_steps * time_sample_flops(bg))
    return bound(nbytes(bg.fields, y0, ug0, vg0, *out), flops)


def phase_rk4(run):
    """The RK4 kernel against the plain run over all 360 steps of the
    production seeding's entry state (float32, 60,784 lanes; float64 on its
    first N_SUBSET lanes), bitwise; the kernel's time there and on the
    default run's entry state (~4,000 lanes, 1,080 steps)."""
    torch = run.torch
    from rwrt_tpu_torch import kernels, tracer

    run.rk4 = {}
    for name in ("production", "default"):
        for dtype in ((torch.float32, torch.float64) if name == "production"
                      else (torch.float32,)):
            args, idx, cfg = rk4_args(run, name, dtype)
            bg, y0, ug0, vg0 = args[:4]
            before = tracer.RK4_LAUNCHES
            kern = tracer._run_rk4(*args)
            check(tracer.RK4_LAUNCHES == before + 1, "rk4 did not launch once")
            plain, plain_ms = plain_call(
                run, f"rk4 {name} {str(dtype)[6:]}", "_run_rk4_plain", *args)
            for k, p, what in zip(kern, plain, ("rows", "ug", "vg")):
                check(same(k, p), f"rk4 {name} {dtype}: {what} differ from "
                      "the plain run")
            tag = f"rk4 {name} {str(dtype)[6:]}"

            def launch(inst):
                return tracer._run_rk4_cuda(*args, inst)

            def same_as(out):
                return all(same(a, b) for a, b in zip(out, plain))

            if dtype == torch.float64:
                for inst in kernels.INSTANCES:
                    check(same_as(launch(inst)),
                          f"{tag}: instance {inst} differs from the plain run")
                print(f"{tag}: R={y0.shape[1]}, {cfg.nt - 1} steps, every "
                      f"instance bitwise equal to the plain run; plain "
                      f"{plain_ms:.1f} ms")
                continue
            ms = cuda_ms(lambda: tracer._run_rk4_cuda(*args), 3)
            b = rk4_bound(bg, y0, ug0, vg0, kern, dtype)
            alive = float(kern[0][-1, 0].isfinite().float().mean())
            print(f"{tag}: R={y0.shape[1]}, {cfg.nt - 1} steps, bitwise equal "
                  f"to the plain run; kernel {ms:.3f} ms (CUDA events), plain "
                  f"{plain_ms:.1f} ms; bound {b['bound_ms']:.4f} ms "
                  f"({b['bound_by']}); lanes alive at the end {alive:.4f}")
            in_turns(run, tag, launch, 3, same_as)
            print_choice(run, tag, tracer.rk4_instance(y0.shape[1], dtype))
            run.rk4[name] = (idx, kern)
            if name == "production":
                err = max(float(torch.nan_to_num(torch.abs(k - p),
                                                 nan=0.0).max())
                          for k, p in zip(kern, plain))
                run.kernels["rk4_run"] = dict(
                    max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    library_ms=None, **b)


def exact_bound(args, out, dtype, attempts, crossings):
    """Bytes: the entry state, bounds and background in, every output out;
    flops: this run's step attempts and crossings; ``dtype`` "mixed"
    splits them as MIX_EXACT_ATTEMPT_FLOPS, the crossings' in float64."""
    bg, y0, ug0, vg0, h0, f0, bounds_g = args[:7]
    if dtype == "mixed":
        flops = {u: attempts * n for u, n in MIX_EXACT_ATTEMPT_FLOPS.items()}
        flops["float64"] += crossings * KILL_FLOPS
    else:
        flops = {str(dtype)[6:]: attempts * EXACT_ATTEMPT_FLOPS
                 + crossings * KILL_FLOPS}
    return bound(nbytes(bg.fields, y0, ug0, vg0, h0, f0, bounds_g, *out),
                 flops)


def phase_exact_group(run):
    """The first 16-bound group of the production seeding in exact mode,
    ``integrate_group``'s kernel against the plain loop on its entry state
    (60,784 lanes), float32 and float64: hist, carry, iters, attempts,
    flags and next bounds bitwise."""
    torch = run.torch
    from rwrt_tpu_torch import kernels
    from rwrt_tpu_torch.models import ray
    from rwrt_tpu_torch.solvers import rk45

    cfg = production_config(run.rt, bound_mode="exact", pin_limit=None,
                            interval_batch=16)
    for dtype in (torch.float32, torch.float64):
        bg, args, _, _ = run.run_inputs(dtype, cfg)
        _, y0, _, _, h0, f0, bounds_g, _, cut_off, rtol, atol, min_step = args
        carry = (y0, torch.zeros_like(h0), h0, f0, y0[0].clone(),
                 y0[1].clone())
        tail = (bounds_g[0], *carry[4:], cut_off, rtol, atol, min_step)

        def plain_rhs(yy, tt=0.0):
            return ray._rhs_core(bg, yy, tt, False)[0]

        def plain_gv(yy, tt=0.0):
            dy, _, ug, vg = ray._rhs_core(bg, yy, tt, True)
            return dy, ug, vg

        def kernel():
            return rk45.integrate_group(ray.RayRHS(bg), None, *carry[:4],
                                        *tail)

        before = rk45.EXACT_LAUNCHES
        kern = kernel()
        check(rk45.EXACT_LAUNCHES == before + 1, "exact group did not launch")
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        plain = rk45._integrate_group_plain(plain_rhs, plain_gv, *carry[:4],
                                            *tail)
        end.record()
        torch.cuda.synchronize()
        plain_ms = start.elapsed_time(end)
        name = str(dtype)[6:]
        for i in range(7):
            check(same(kern[i], plain[i]), f"exact_group {name}: output {i} "
                  "differs from the plain loop")
        check(int(kern[7]) == plain[7], f"exact_group {name}: iters differ")
        for i in (9, 10, 11, 12):
            check(torch.equal(kern[i], plain[i]),
                  f"exact_group {name}: output {i} differs")

        def launch(inst):
            return rk45._integrate_group_cuda(
                ray.RayRHS(bg), None, *carry[:4], *tail, MAX_ITERS, None, inst)

        def same_as(out):
            return (all(same(out[i], plain[i]) for i in range(7))
                    and int(out[7]) == plain[7]
                    and all(torch.equal(out[i], plain[i])
                            for i in (9, 10, 11, 12)))

        tag = f"exact_group {name}"
        if dtype == torch.float64:
            for inst in kernels.INSTANCES:
                check(same_as(launch(inst)),
                      f"{tag}: instance {inst} differs from the plain loop")
        else:
            in_turns(run, tag, launch, 5, same_as)
            print_choice(run, tag, rk45.exact_instance(y0.shape[1], dtype,
                                                       run=False))
        ms = cuda_ms(kernel, 5)
        attempts = int(kern[9].sum())
        b = exact_bound(args, kern[:7] + kern[9:], dtype, attempts,
                        int(kern[0][:, 5].isfinite().sum()))
        print(f"exact_group {name}: R={y0.shape[1]}, 16 bounds, bitwise equal "
              f"to the plain loop; trips {int(kern[7])}, step attempts "
              f"{attempts}; kernel {ms:.3f} ms (CUDA events), plain "
              f"{plain_ms:.1f} ms, bound {b['bound_ms']:.4f} ms "
              f"({b['bound_by']})")
        if dtype == torch.float32:
            run.kernels["exact_group"] = dict(
                max_abs_err=0.0, ms=ms, plain_ms=plain_ms, library_ms=None,
                **b)
    exact_group_mixed(run, cfg)


def exact_group_mixed(run, cfg):
    """The single-group exact kernel's mixed instance (a float64 state over
    the float32 background) on the first 16-bound group of the production
    seeding: every instance bitwise equal to the plain loop."""
    torch = run.torch
    from rwrt_tpu_torch import kernels
    from rwrt_tpu_torch.models import ray
    from rwrt_tpu_torch.solvers import rk45

    f64 = torch.float64
    key = (f64, torch.float32)
    bg, args, _, _ = run.run_inputs(torch.float32, cfg, state=f64)
    _, y0, _, _, h0, f0, bounds_g, _, cut_off, rtol, atol, min_step = args
    carry = (y0, torch.zeros_like(h0), h0, f0, y0[0].clone(), y0[1].clone())
    tail = (bounds_g[0], *carry[4:], cut_off, rtol, atol, min_step)

    def plain_rhs(yy, tt=0.0):
        return ray._rhs_core(bg, yy, tt, False)[0]

    def plain_gv(yy, tt=0.0):
        dy, _, ug, vg = ray._rhs_core(bg, yy, tt, True)
        return dy, ug, vg

    def launch(inst=None):
        return rk45._integrate_group_cuda(
            ray.RayRHS(bg), None, *carry[:4], *tail, MAX_ITERS, None, inst)

    before = rk45.EXACT_LAUNCHES
    kern = rk45.integrate_group(ray.RayRHS(bg), None, *carry[:4], *tail)
    check(rk45.EXACT_LAUNCHES == before + 1, "mixed exact group did not launch")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    plain = rk45._integrate_group_plain(plain_rhs, plain_gv, *carry[:4], *tail)
    end.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(end)

    def same_as(out):
        return (all(out[i].dtype == plain[i].dtype and same(out[i], plain[i])
                    for i in range(7))
                and int(out[7]) == plain[7]
                and all(torch.equal(out[i], plain[i])
                        for i in (9, 10, 11, 12)))

    check(same_as(kern), "mixed exact_group differs from the plain loop")
    for inst in kernels.INSTANCES:
        check(same_as(launch(inst)),
              f"mixed exact_group: instance {inst} differs from the plain loop")
    ms = cuda_ms(launch, 5)
    attempts = int(kern[9].sum())
    b = exact_bound(args, kern[:7] + kern[9:], "mixed", attempts,
                    int(kern[0][:, 5].isfinite().sum()))
    print(f"exact_group mixed: R={y0.shape[1]}, 16 bounds, every instance "
          f"bitwise equal to the plain loop; trips {int(kern[7])}, step "
          f"attempts {attempts}; launcher's instance "
          f"{rk45.exact_instance(y0.shape[1], key, run=False)}, kernel "
          f"{ms:.3f} ms (CUDA events), plain {plain_ms:.1f} ms, bound "
          f"{b['bound_ms']:.4f} ms ({b['bound_by']})")
    run.kernels["exact_group_mix"] = dict(
        max_abs_err=0.0, ms=ms, plain_ms=plain_ms, library_ms=None, **b)


def phase_exact_run(run):
    """The whole-run exact kernel against the plain ``_exact_run_plain``:
    float32 on the README run's entry state (4,288 lanes) over README_DAYS
    days (480 bounds in 30 groups of 16; the plain run takes ~45 s), timed;
    float64 on its first EXACT_SUBSET lanes over its first EXACT_DAYS days
    (12 groups, ~20 s); rows, (ug, vg), attempts, truncation counts and
    carry bitwise."""
    torch = run.torch
    from rwrt_tpu_torch import kernels, tracer
    from rwrt_tpu_torch.models import ray
    from rwrt_tpu_torch.solvers import rk45

    for dtype in (torch.float32, torch.float64):
        # float64: the first EXACT_SUBSET lanes over EXACT_DAYS days.
        args, idx, cfg = exact_run_args(run, dtype)
        name = str(dtype)[6:]
        before = tracer.EXACT_LAUNCHES
        kern = tracer._exact_run(*args)
        check(tracer.EXACT_LAUNCHES == before + 1,
              "exact_run did not launch once")
        ms = cuda_ms(lambda: tracer._exact_run(*args), 3)
        plain, plain_ms = plain_call(run, f"exact_run {name}",
                                     "_exact_run_plain", *args)
        for n in ("ys", "ugs", "vgs", "lane_att", "trunc"):
            check(same(getattr(kern, n), getattr(plain, n)),
                  f"exact_run {name}: {n} differs from the plain run")
        for a, b in zip(kern.carry, plain.carry):
            check(same(a, b), f"exact_run {name}: carry differs")

        def launch(inst, args=args, **kw):
            return tracer._exact_run_cuda(*args, instance=inst, **kw)

        def same_as(out, plain=plain):
            return (all(same(getattr(out, n), getattr(plain, n))
                        for n in ("ys", "ugs", "vgs", "lane_att", "trunc"))
                    and all(same(a, b) for a, b in zip(out.carry,
                                                       plain.carry)))

        tag = f"exact_run {name}"
        if dtype == torch.float64:
            for inst in kernels.INSTANCES:
                check(same_as(launch(inst)),
                      f"{tag}: instance {inst} differs from the plain run")
        else:
            in_turns(run, tag, launch, 3, same_as)
            print_choice(run, tag, rk45.exact_instance(args[1].shape[1],
                                                       dtype))
        # The barrier flag (``_run_rk45`` on the card): one bound per group
        # over BARRIER_DAYS days, every 7th lane's amp at the dtype's
        # largest value (it overflows to NaN inside the first interval).
        sub = lane_subset(args, EXACT_SUBSET)
        y0 = sub[1].clone()
        y0[4, ::7] = torch.finfo(dtype).max
        f0 = ray.RayRHS(sub[0])(y0)
        n_b = int(BARRIER_DAYS * DAY / cfg.tstep)
        one = tracer.padded_bounds(rk45.as_scalar(cfg.tstep, dtype), n_b + 1,
                                   1, dtype, run.dev)
        bargs = (sub[0], y0, *sub[2:5], f0, one, n_b, *sub[8:])
        bplain = tracer._exact_run_plain(*bargs, 100_000, barrier=True)
        for inst in kernels.INSTANCES:
            check(same_as(launch(inst, bargs, max_iters=100_000,
                                 barrier=True), bplain),
                  f"{tag}: barrier kernel, instance {inst}, differs from "
                  "the flagged plain run")
        grouped = tracer._exact_run_plain(*bargs, 100_000)
        moved = int((~((grouped.ys == bplain.ys)
                       | (grouped.ys.isnan() & bplain.ys.isnan()))
                     ).any(dim=1).any(dim=0).sum())
        print(f"  barrier flag: {EXACT_SUBSET} lanes x {n_b} one-bound "
              f"groups, every instance bitwise equal to the flagged plain "
              f"run; lanes whose rows the flag changes: {moved}")
        trips = kern.lane_att.sum(dim=0)
        attempts = int(kern.lane_att.sum())
        bnd = exact_bound(args, kern[:5] + kern.carry, dtype, attempts,
                          int(kern.ugs[1:].isfinite().sum()))
        print(f"exact_run {name}: R={args[1].shape[1]}, "
              f"{kern.ys.shape[0] - 1} bounds in {kern.lane_att.shape[0]} "
              f"groups, bitwise equal to the plain run (rows, ug, vg, "
              f"lane_att, trunc, carry); kernel {ms:.3f} ms (CUDA events), "
              f"plain {plain_ms:.1f} ms, bound {bnd['bound_ms']:.4f} ms "
              f"({bnd['bound_by']}); step attempts {attempts}, most trips "
              f"per group {kern.lane_att.amax(dim=1).tolist()}, longest lane "
              f"{int(trips.max())} trips in all, truncated lane-groups "
              f"{int(kern.trunc.sum())}")
        if dtype == torch.float32:
            run.exact_run = (idx, kern)
            run.kernels["exact_run"] = dict(
                max_abs_err=0.0, ms=ms, plain_ms=plain_ms, library_ms=None,
                **bnd)


def traced(run, cfg, launches_of, n_launches=1, driver=None, stop=(),
           bs=None, **kw):
    """One ``trace_rays`` (or ``driver``, a function of the same
    arguments) on the climatology background (or ``bs``), float32, with
    every launch
    counter set to 0 just before it and read just after: ``n_launches``
    of ``launches_of`` and none of the other kernels but, as
    ``read_launches`` has it, the RHS or an adaptive run's entry stage.
    Returns
    (traj, launches, wall s, peak MiB above the prepared state, stats,
    the MaxItersTruncation, or exception of a type in ``stop``, that
    ended the run, or None; traj is None then)."""
    torch = run.torch
    from rwrt_tpu_torch import tracer

    bs = run.bs(torch.float32) if bs is None else bs
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    stats = {}
    reset_launches()
    t0 = time.perf_counter()
    try:
        traj = (driver or run.rt.trace_rays)(bs, cfg, stats=stats, **kw)
        refused = None
    except (tracer.MaxItersTruncation, *stop) as e:
        traj, refused = None, e
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
    launches = read_launches(launches_of, n_launches, "trace_rays")
    return traj, launches, wall, peak, stats, refused


def reset_launches():
    """Set every kernel wrapper's launch counter to 0."""
    from rwrt_tpu_torch import tracer
    from rwrt_tpu_torch.diagnostics import flux
    from rwrt_tpu_torch.models import ray
    from rwrt_tpu_torch.ops import spectral_sample as spec
    from rwrt_tpu_torch.solvers import rk45

    from rwrt_tpu_torch.probes import gather_probe

    ray.LAUNCHES = rk45.LAUNCHES = rk45.EXACT_LAUNCHES = spec.LAUNCHES = 0
    rk45.INTERVAL_LAUNCHES = tracer.ENTRY_LAUNCHES = 0
    tracer.LAUNCHES = tracer.RK4_LAUNCHES = tracer.EXACT_LAUNCHES = 0
    flux.LAUNCHES = flux.REGION_LAUNCHES = gather_probe.LAUNCHES = 0


def read_launches(launches_of, n_launches, what):
    """The counters since ``reset_launches``: fails unless ``launches_of``
    launched ``n_launches`` times (or, a dict, each of its kernels its
    count) and no other kernel ran but the RHS, any number of times, and
    the entry stage, never: where an adaptive run's kernel (dense_run or
    exact_run) is named, its entry stage once (unless named) and the RHS
    never."""
    from rwrt_tpu_torch import tracer
    from rwrt_tpu_torch.diagnostics import flux
    from rwrt_tpu_torch.models import ray
    from rwrt_tpu_torch.ops import spectral_sample as spec
    from rwrt_tpu_torch.probes import gather_probe
    from rwrt_tpu_torch.solvers import rk45

    launches = {"rhs": ray.LAUNCHES, "dense_group": rk45.LAUNCHES,
                "dense_run": tracer.LAUNCHES, "spectral": spec.LAUNCHES,
                "rk4_run": tracer.RK4_LAUNCHES,
                "exact_group": rk45.EXACT_LAUNCHES,
                "exact_run": tracer.EXACT_LAUNCHES,
                "flux": flux.LAUNCHES, "flux_region": flux.REGION_LAUNCHES,
                "gather": gather_probe.LAUNCHES,
                "interval": rk45.INTERVAL_LAUNCHES,
                "entry": tracer.ENTRY_LAUNCHES}
    wants = (launches_of if isinstance(launches_of, dict)
             else {launches_of: n_launches})
    adaptive = "dense_run" in wants or "exact_run" in wants
    defaults = {"rhs": 0 if adaptive else None, "entry": int(adaptive)}
    for k, n in launches.items():
        want = wants.get(k, defaults.get(k, 0))
        check(want is None or n == want,
              f"{what} made {n} {k} launches, not {want}")
    return launches


def check_rows(traj, idx, kern, what):
    """The trajectory's compacted lanes equal a kernel run's rows (moved to
    the trajectory's device: the chunked driver's are on the host)."""
    kern = [k.to(traj.lon.device) for k in kern[:3]]
    nt = kern[0].shape[0]
    flat = {k: getattr(traj, k).reshape(nt, -1)[:, idx]
            for k in traj._fields}
    for k, row in (("lon", 0), ("lat", 1), ("kx", 2), ("ky", 3), ("amp", 4)):
        check(same(flat[k], kern[0][:, row]),
              f"{what}: trace_rays {k} differs from the kernel phase's rows")
    check(same(flat["ug"], kern[1]) and same(flat["vg"], kern[2]),
          f"{what}: trace_rays (ug, vg) differ from the kernel phase's")
    alive_end = traj.ky[-1].isfinite()
    for k in traj._fields:
        check(bool(getattr(traj, k)[-1][alive_end].isfinite().all()),
              f"{what}: non-finite {k} on a lane alive at the end")


def phase_rk4_path(run):
    """The two RK4 runs through ``trace_rays``: ``RunConfig()`` (6,615
    rays, 90 days) and the production seeding (100,800 rays, 30 days). The
    kernels line reports the production run's launches."""
    for name, cfg, kw in (
            ("default", default_config(run.rt), {}),
            ("production", rk4_production_config(run.rt),
             dict(source_lon=run.slon, source_lat=run.slat))):
        traj, launches, wall, peak, stats, refused = traced(
            run, cfg, "rk4_run", **kw)
        check(refused is None and not stats, "an rk4 run filled stats")
        idx, kern = run.rk4[name]
        check_rows(traj, idx, kern, f"rk4 {name}")
        n_rays = traj.lon[0].numel()
        alive = float(traj.lon[-1].isfinite().float().mean())
        print(f"rk4_path {name}: {n_rays} rays x {cfg.nt - 1} steps, wall "
              f"{wall:.3f} s, peak device memory {peak:.1f} MiB above the "
              f"prepared state, alive fraction at the end {alive:.4f}; "
              f"launches {launches}; rows bitwise equal to the rk4 phase's")
        run.launches["rk4_run"] = launches["rk4_run"]


def phase_exact_path(run):
    """The README run through ``trace_rays`` over README_DAYS days; then
    over TRUNC_DAYS days, where it must raise ``MaxItersTruncation`` after
    its one launch, with its attempts in ``stats``."""
    cfg = readme_config(run.rt)
    traj, launches, wall, peak, stats, refused = traced(run, cfg,
                                                        "exact_run")
    check(refused is None, f"the README run was refused: {refused}")
    idx, kern = run.exact_run
    check_rows(traj, idx, kern, "exact")
    lane_att = stats["lane_att"]
    check(run.torch.equal(lane_att, kern.lane_att),
          "trace_rays' attempts differ from the exact_run phase's")
    print(f"exact_path: {traj.lon[0].numel()} rays x {cfg.nt - 1} bounds, "
          f"wall {wall:.3f} s, peak device memory {peak:.1f} MiB above the "
          f"prepared state, step attempts {int(lane_att.sum())}, longest "
          f"lane {int(lane_att.sum(dim=0).max())} trips; launches "
          f"{launches}; rows bitwise equal to the exact_run phase's")
    run.launches["exact_run"] = launches["exact_run"]
    run.launches["exact_group"] = launches["exact_group"]
    cfg = readme_config(run.rt, TRUNC_DAYS)
    _, launches, wall, _, stats, refused = traced(run, cfg, "exact_run")
    lane_att = stats["lane_att"]
    capped = lane_att.amax(dim=1) == MAX_ITERS
    check(refused is not None, f"the {TRUNC_DAYS}-day README run was not "
          "refused by MaxItersTruncation")
    check(bool(capped.any()), "no group reached the max_iters backstop")
    trips = lane_att.sum(dim=0)
    lone = int(trips.argmax())
    print(f"exact_path {TRUNC_DAYS} days: refused by MaxItersTruncation "
          f"({refused}) after {wall:.3f} s and one launch; groups at the "
          f"{MAX_ITERS:,}-trip backstop: "
          f"{capped.nonzero().flatten().tolist()}; the longest lane "
          f"(compacted lane {lone}) {int(trips[lone])} trips, "
          f"{wall / int(trips[lone]) * 1e6:.3f} us per trip of the wall")
    phase_lone_lane(run, cfg, lone)


def phase_lone_lane(run, cfg, lane):
    """The stalled lane of the TRUNC_DAYS-day README run alone (R = 1) over
    those days, with a backstop of LONE_MAX_ITERS trips per group: every
    instance bitwise equal to Lane's run and timed in turns, as us per
    trip."""
    torch = run.torch
    from rwrt_tpu_torch import tracer
    from rwrt_tpu_torch.solvers import rk45

    _, args, _, _ = run.run_inputs(torch.float32, cfg, cfg)
    r = args[1].shape[1]
    one = tuple(a[..., lane:lane + 1].contiguous()
                if hasattr(a, "shape") and a.ndim and a.shape[-1] == r else a
                for a in args)

    def launch(inst):
        return tracer._exact_run_cuda(*one, LONE_MAX_ITERS, instance=inst)

    ref = launch("lane")
    trips = int(ref.lane_att.sum())

    def same_as(out):
        return all(same(getattr(out, n), getattr(ref, n))
                   for n in ("ys", "ugs", "vgs", "lane_att", "trunc"))

    tag = "exact lone lane"
    times = in_turns(run, tag, launch, 1, same_as)
    print(f"  {tag}: {trips} trips over {cfg.nt - 1} bounds (backstop "
          f"{LONE_MAX_ITERS:,}), us per trip " + ", ".join(
              f"{n} {' / '.join(f'{t / trips * 1e3:.3f}' for t in ts)}"
              for n, ts in times.items()))
    print_choice(run, tag, rk45.exact_instance(1, torch.float32))


def phase_chunked(run):
    """The chunked driver (``utils.checkpoint.trace_rays_chunked``): the
    30-day production run in chunks of its group (CHUNK_STEPS), one dense
    launch per chunk, rows bitwise equal to main_path's; the same run cut
    by a two-chunk budget with a checkpoint and streamed history, then
    resumed, bitwise equal to it; the driver on a subset of the sources
    over CHUNK_PLAIN_CHUNKS chunks with ``tracer._dense_run`` replaced by
    its plain version, bitwise equal to the kernel's; the LONG_DAYS-day
    production run through ``trace_rays``, which must reroute to the
    driver (default chunk_steps), with the wall's split, peak device
    memory and host history bytes; the RK4 default run in chunks of
    RK4_CHUNK_STEPS, rows bitwise equal to rk4_path's."""
    import os
    import tempfile

    torch = run.torch
    from rwrt_tpu_torch import tracer
    from rwrt_tpu_torch.utils import checkpoint

    driver = checkpoint.trace_rays_chunked
    src = dict(source_lon=run.slon, source_lat=run.slat)
    cfg = production_config(run.rt)
    n_chunks = -(-(cfg.nt - 1) // CHUNK_STEPS)
    kw = dict(chunk_steps=CHUNK_STEPS, verbose=False, **src)
    traj, launches, wall, peak, stats, refused = traced(
        run, cfg, "dense_run", n_chunks, driver, **kw)
    check(refused is None, f"the chunked production run was refused: "
          f"{refused}")
    check(traj.lon.device.type == "cpu", "the chunked rows are not on the "
          "host")
    idx, kern = run.dense_run
    check_rows(traj, idx, kern, "chunked 30 days")
    attempts = sum(int(a.sum()) for a in stats["lane_att"])
    widths = [a.shape[1] for a in stats["lane_att"]]
    check(attempts == DENSE_ATTEMPTS,
          f"chunked: {attempts} step attempts, not {DENSE_ATTEMPTS}")
    print(f"chunked {N_DAYS} days: {n_chunks} chunks of {CHUNK_STEPS}, "
          f"launches {launches}, wall {wall:.3f} s, kernel per chunk "
          f"{[round(x, 3) for x in stats['chunk_ms']]} ms, host "
          f"{ {k: round(v, 4) for k, v in stats['seconds'].items()} } s, "
          f"lanes per chunk {widths}, peak device memory {peak:.1f} MiB "
          f"above the prepared state; step attempts {attempts}; rows "
          "bitwise equal to main_path's")
    from profile_main_path import repacked_occupancy, warp_occupancy

    key = (torch.float32, torch.float32)
    blocks, block = tracer.dense_grid(key)
    every, trigger = tracer.DENSE_SCHEDULE[key]
    print("  chunked warp occupancy per chunk, launch order / repacked: "
          + ", ".join(
              f"{warp_occupancy(a):.4f} / "
              f"{repacked_occupancy(a, block, blocks, every, trigger)[0]:.4f}"
              for a in stats["lane_att"]))

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ck.npz")
        paths = dict(checkpoint_path=path, stream_dir=os.path.join(tmp, "s"))
        _, first, wall1, _, _, stopped = traced(
            run, cfg, "dense_run", 2, driver, stop=(
                checkpoint.ChunkBudgetReached,), max_chunks=2, **paths, **kw)
        check(isinstance(stopped, checkpoint.ChunkBudgetReached)
              and stopped.step == 1 + 2 * CHUNK_STEPS,
              f"the budgeted run ended with {stopped!r}")
        resumed, rest, wall2, _, _, refused = traced(
            run, cfg, "dense_run", n_chunks - 2, driver, **paths, **kw)
        check(refused is None, f"the resumed run was refused: {refused}")
        for k in traj._fields:
            check(same(getattr(resumed, k), getattr(traj, k)),
                  f"resumed: {k} differs from the uninterrupted run")
        del resumed
    print(f"chunked resume: {CHUNK_STEPS * 2}-step budget "
          f"(ChunkBudgetReached at step {stopped.step}, {wall1:.3f} s, "
          f"launches {first}), resumed from the checkpoint and the streamed "
          f"history ({wall2:.3f} s, launches {rest}); rows bitwise equal to "
          "the uninterrupted run's")
    del traj

    part = dict(kw, source_lon=run.slon[:CHUNK_PLAIN_SOURCES],
                source_lat=run.slat[:CHUNK_PLAIN_SOURCES])
    cfg_p = production_config(
        run.rt, ttotal=CHUNK_PLAIN_CHUNKS * CHUNK_STEPS * cfg.tstep)
    k_traj, k_launch, k_wall, _, k_stats, _ = traced(
        run, cfg_p, "dense_run", CHUNK_PLAIN_CHUNKS, driver, **part)
    unit = tracer._dense_run
    tracer._dense_run = tracer._dense_run_plain
    try:
        p_traj, p_launch, p_wall, _, _, _ = traced(
            run, cfg_p, "dense_run", 0, driver, **part)
    finally:
        tracer._dense_run = unit
    for k in k_traj._fields:
        check(same(getattr(k_traj, k), getattr(p_traj, k)),
              f"chunked plain units: {k} differs from the kernel's")
    print(f"chunked against its plain units: {CHUNK_PLAIN_SOURCES} sources "
          f"({k_stats['lane_att'][0].shape[1]} lanes) x "
          f"{CHUNK_PLAIN_CHUNKS} chunks, rows bitwise equal; kernel driver "
          f"{k_wall:.3f} s (launches {k_launch}), plain driver {p_wall:.1f} s "
          f"(launches {p_launch})")

    cfg90 = production_config(run.rt, ttotal=LONG_DAYS * DAY)
    n90 = -(-(cfg90.nt - 1) // DEFAULT_CHUNK_STEPS)
    traj, launches, wall, peak, stats, refused = traced(
        run, cfg90, "dense_run", n90, **src)
    check(refused is None, f"the {LONG_DAYS}-day run was refused: {refused}")
    check(traj.lon.device.type == "cpu",
          f"the {LONG_DAYS}-day trace_rays did not reroute")
    n_rays = 3 * N_SOURCES * 7
    for k in traj._fields:
        check(tuple(getattr(traj, k).shape) == (cfg90.nt, 3, N_SOURCES, 7),
              f"{LONG_DAYS} days: {k} shape {tuple(getattr(traj, k).shape)}")
    alive_end = traj.ky[-1].isfinite()
    for k in traj._fields:
        check(bool(getattr(traj, k)[-1][alive_end].isfinite().all()),
              f"{LONG_DAYS} days: non-finite {k} on a lane alive at the end")
    kernel_s = sum(stats["chunk_ms"]) / 1e3
    host = stats["seconds"]
    other = wall - kernel_s - sum(host.values())
    hist_bytes = 7 * cfg90.nt * n_rays * traj.lon.element_size()
    split = dict(wall=wall, kernel=kernel_s, **host, other=other)
    print(f"chunked {LONG_DAYS} days through trace_rays (rerouted): {n_rays} "
          f"rays x {cfg90.nt - 1} steps, {n90} chunks of "
          f"{DEFAULT_CHUNK_STEPS}, launches {launches}; alive fraction at the "
          f"end {float(alive_end.float().mean()):.4f}; step attempts "
          f"{sum(int(a.sum()) for a in stats['lane_att'])}; lanes per chunk "
          f"{[a.shape[1] for a in stats['lane_att']]}; peak device memory "
          f"{peak:.1f} MiB above the prepared state; host history "
          f"{hist_bytes} B")
    print(f"chunked {LONG_DAYS} days wall split (s): " + json.dumps(split))
    print(f"chunked {LONG_DAYS} days kernel per chunk (ms): "
          f"{[round(x, 3) for x in stats['chunk_ms']]}")
    del traj

    cfg = default_config(run.rt)
    n_rk4 = -(-(cfg.nt - 1) // RK4_CHUNK_STEPS)
    traj, launches, wall, _, stats, _ = traced(
        run, cfg, "rk4_run", n_rk4, driver, chunk_steps=RK4_CHUNK_STEPS,
        verbose=False)
    check_rows(traj, *run.rk4["default"], "chunked rk4 default")
    print(f"chunked rk4 default: {n_rk4} chunks of {RK4_CHUNK_STEPS}, wall "
          f"{wall:.3f} s, kernel {sum(stats['chunk_ms']):.3f} ms in all, "
          f"launches {launches}; rows bitwise equal to rk4_path's")


def phase_mixed_chunked(run):
    """The chunked driver in mixed precision: the README run over
    MIXED_README_DAYS days in chunks of its group (16), one exact launch
    per chunk, and the production dense run over N_DAYS days in chunks of
    CHUNK_STEPS, one dense launch per chunk; float64 rows bitwise equal to
    mixed_exact's and mixed_dense's."""
    from rwrt_tpu_torch.utils import checkpoint

    driver = checkpoint.trace_rays_chunked
    for name, cfg, of, group, ref, kw in (
            ("readme exact", readme_config(run.rt, MIXED_README_DAYS),
             "exact_run", 16, run.mixed_exact, {}),
            ("production dense", production_config(run.rt), "dense_run",
             CHUNK_STEPS, run.mixed_dense,
             dict(source_lon=run.slon, source_lat=run.slat))):
        n = -(-(cfg.nt - 1) // group)
        traj, launches, wall, peak, stats, refused = traced(
            run, mixed(cfg), of, n, driver, chunk_steps=group, verbose=False,
            **kw)
        check(refused is None, f"mixed chunked {name} was refused: {refused}")
        all_float64(traj, f"mixed chunked {name}")
        check_rows(traj, *ref, f"mixed chunked {name}")
        print(f"mixed chunked {name}: {n} chunks of {group}, wall "
              f"{wall:.3f} s, kernel {sum(stats['chunk_ms']):.3f} ms in all, "
              f"peak device memory {peak:.1f} MiB above the prepared state; "
              f"launches {launches}; float64 rows bitwise equal to the "
              "one-launch run's")


def mixed(cfg, **changes):
    """``cfg`` in mixed precision: a float64 state over its float32
    background."""
    import dataclasses

    return dataclasses.replace(cfg, state_dtype="float64", **changes)


def all_float64(traj, what):
    """Every output of a trajectory is float64."""
    for k in traj._fields:
        dt = getattr(traj, k).dtype
        check(str(dt) == "torch.float64", f"{what}: {k} is {dt}, not float64")


def phase_mixed_dense(run):
    """The production run in mixed precision (a float64 state over the
    float32 background): the whole-run kernel's mixed instance on
    ``trace_rays``' entry state, timed, and on its first N_SUBSET lanes
    over its first MIXED_PLAIN_GROUPS groups bitwise against the plain
    ``_dense_run_plain`` (and against the full run's rows); then the run
    through ``trace_rays``: one whole-run launch, all seven outputs
    float64, rows bitwise equal to the kernel's."""
    torch = run.torch
    from rwrt_tpu_torch import tracer

    args, kw, idx, sub = mixed_dense_args(run)
    before = tracer.LAUNCHES
    kern = tracer._dense_run(*args, **kw)
    check(tracer.LAUNCHES == before + 1, "mixed dense_run did not launch once")
    ms = cuda_ms(lambda: tracer._dense_run(*args, **kw), 3)
    n_rows = sub[7]
    part = tracer._dense_run(*sub, **kw)
    plain, plain_ms = plain_call(run, "mixed dense_run", "_dense_run_plain",
                                 *sub, **kw)
    for n in ("ys", "ugs", "vgs", "lane_att", "trunc"):
        check(same(getattr(part, n), getattr(plain, n)),
              f"mixed dense_run: {n} differs from the plain run")
        full = getattr(kern, n)[..., :N_SUBSET]
        if n in ("ys", "ugs", "vgs"):
            full = full[:n_rows + 1]
        elif n == "lane_att":
            full = full[:MIXED_PLAIN_GROUPS]
        else:
            continue  # the truncation count is the whole run's
        check(same(getattr(part, n), full.contiguous()),
              f"mixed dense_run: the first {N_SUBSET} lanes' {n} differ "
              "from the full run's")
    for a, b in zip(part.carry, plain.carry):
        check(same(a, b), "mixed dense_run: carry differs")
    b = dense_run_bound(args, kern, "mixed")
    trips = kern.lane_att.sum(dim=0)
    attempts = int(kern.lane_att.sum())
    print(f"mixed dense_run: R={args[1].shape[1]}, {kern.ys.shape[0] - 1} "
          f"bounds in {kern.lane_att.shape[0]} groups; kernel {ms:.3f} ms "
          f"(CUDA events), bound {b['bound_ms']:.4f} ms ({b['bound_by']}); "
          f"step attempts {attempts}, longest lane {int(trips.max())} trips "
          f"in all, truncated lane-groups {int(kern.trunc.sum())}; the first "
          f"{N_SUBSET} lanes over the first {MIXED_PLAIN_GROUPS} groups "
          f"bitwise equal to the plain run (rows, ug, vg, lane_att, trunc, "
          f"carry; plain {plain_ms:.1f} ms) and to the full run's rows")
    cfg = mixed(production_config(run.rt))
    traj, launches, wall, peak, stats, refused = traced(
        run, cfg, "dense_run", source_lon=run.slon, source_lat=run.slat)
    check(refused is None, f"the mixed production run was refused: {refused}")
    all_float64(traj, "mixed dense trace_rays")
    check_rows(traj, idx, kern, "mixed dense")
    check(torch.equal(stats["lane_att"], kern.lane_att),
          "mixed dense: trace_rays' attempts differ from the kernel's")
    print(f"mixed dense trace_rays: wall {wall:.3f} s, peak device memory "
          f"{peak:.1f} MiB above the prepared state; launches {launches}; "
          "all seven outputs float64, rows bitwise equal to the kernel's")
    err = max(float(torch.nan_to_num(torch.abs(k - p), nan=0.0).max())
              for k, p in ((part.ys, plain.ys), (part.ugs, plain.ugs),
                           (part.vgs, plain.vgs)))
    rec = dense_report(run, "mixed dense_run", args, kw, kern)
    run.kernels["dense_run_mix"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
        chain_floor_ms=rec["chain_floor_ms"], **b)
    run.launches["dense_run_mix"] = launches["dense_run"]
    run.launches["dense_group_mix"] = launches["dense_group"]
    run.mixed_dense = (idx, kern)


def phase_mixed_drift(run):
    """The production run through ``trace_rays`` in float32, in mixed
    precision and in float64 (a float64 background): the day-30 median
    great-circle drift of float32 and of mixed against float64, in
    degrees, over the rays finite at day 30 in both; each run's step
    attempts and its whole-run kernel's time. A record, not a gate."""
    torch = run.torch
    from rwrt_tpu_torch import tracer

    f32, f64 = torch.float32, torch.float64
    res = {}
    for name, bs_dtype, state in (("float32", f32, None),
                                  ("mixed", f32, f64),
                                  ("float64", f64, None)):
        cfg = production_config(
            run.rt, cal_dtype=str(bs_dtype)[6:],
            state_dtype="compute" if state is None else "float64")
        stats = {}
        # The float64 history (4.1 GB) is past the 2 GiB estimate at which
        # trace_rays reroutes to the chunked driver; the card holds it, and
        # the drift is the one-launch run's.
        traj = run.rt.trace_rays(run.bs(bs_dtype), cfg, source_lon=run.slon,
                                 source_lat=run.slat, stats=stats,
                                 auto_chunk_bytes=None)
        _, args, kw, _ = run.run_inputs(bs_dtype, state=state)
        ms = cuda_ms(lambda: tracer._dense_run(*args, **kw), 3)
        res[name] = (torch.stack([traj.lon[-1], traj.lat[-1]]).reshape(2, -1)
                     .double(), int(stats["lane_att"].sum()), ms)
        del traj, args
        print(f"drift {name}: step attempts {res[name][1]}, dense kernel "
              f"{ms:.3f} ms (CUDA events)")
    ref = res["float64"][0]
    for name in ("float32", "mixed"):
        pos = res[name][0]
        both = pos.isfinite().all(dim=0) & ref.isfinite().all(dim=0)
        d = _group_pos_diff_deg(pos[:, both], ref[:, both])
        print(f"drift {name} against float64: day-30 median "
              f"{float(d.median())!r} deg over {int(both.sum())} rays finite "
              "in both")


def phase_mixed_rk4(run):
    """RK4 in mixed precision at the production seeding (30 days) and in
    the default run: the kernel's mixed instance against the plain run
    over all steps, bitwise, every instance bitwise and timed in turns;
    then each run through ``trace_rays`` with state_dtype float64: one RK4
    launch, float64 outputs, rows bitwise equal to the kernel's."""
    torch = run.torch
    from rwrt_tpu_torch import tracer

    f64 = torch.float64
    key = (f64, torch.float32)
    for name, kw in (
            ("production", dict(source_lon=run.slon, source_lat=run.slat)),
            ("default", {})):
        args, idx, cfg = rk4_args(run, name, torch.float32, f64)
        bg, y0, ug0, vg0 = args[:4]
        before = tracer.RK4_LAUNCHES
        kern = tracer._run_rk4(*args)
        check(tracer.RK4_LAUNCHES == before + 1,
              "mixed rk4 did not launch once")
        tag = f"mixed rk4 {name}"
        plain, plain_ms = plain_call(run, tag, "_run_rk4_plain", *args)
        for k, p, what in zip(kern, plain, ("rows", "ug", "vg")):
            check(same(k, p), f"{tag}: {what} differ from the plain run")
        ms = cuda_ms(lambda: tracer._run_rk4_cuda(*args), 3)
        b = rk4_bound(bg, y0, ug0, vg0, kern, "mixed")
        print(f"{tag}: R={y0.shape[1]}, {cfg.nt - 1} steps, bitwise equal "
              f"to the plain run; kernel {ms:.3f} ms (CUDA events), plain "
              f"{plain_ms:.1f} ms; bound {b['bound_ms']:.4f} ms "
              f"({b['bound_by']})")

        def launch(inst):
            return tracer._run_rk4_cuda(*args, inst)

        def same_as(out):
            return all(same(a, b) for a, b in zip(out, plain))

        in_turns(run, tag, launch, 3, same_as)
        print_choice(run, tag, tracer.rk4_instance(y0.shape[1], key))
        traj, launches, wall, peak, stats, refused = traced(
            run, mixed(cfg), "rk4_run", **kw)
        check(refused is None and not stats, "an rk4 run filled stats")
        all_float64(traj, f"{tag} trace_rays")
        check_rows(traj, idx, kern, tag)
        print(f"{tag} trace_rays: wall {wall:.3f} s; launches {launches}; "
              "float64 outputs, rows bitwise equal to the kernel's")
        if name == "production":
            err = max(float(torch.nan_to_num(torch.abs(k - p),
                                             nan=0.0).max())
                      for k, p in zip(kern, plain))
            run.kernels["rk4_run_mix"] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
                **b)
            run.launches["rk4_run_mix"] = launches["rk4_run"]


def phase_mixed_exact(run):
    """The README run at its full MIXED_README_DAYS days in mixed
    precision: the whole-run kernel's mixed instance, timed, no lane-group
    cut short by the max_iters backstop, every instance bitwise equal to
    the launcher's run and timed in turns; every instance bitwise against
    the plain ``_exact_run_plain`` on its first EXACT_SUBSET lanes over
    EXACT_DAYS days, and the barrier flag's instances against the flagged
    plain run there; then the run through ``trace_rays``: one exact launch,
    no ``MaxItersTruncation``, float64 outputs, rows bitwise equal to the
    kernel's."""
    torch = run.torch
    from rwrt_tpu_torch import kernels, tracer
    from rwrt_tpu_torch.models import ray
    from rwrt_tpu_torch.solvers import rk45

    f64 = torch.float64
    key = (f64, torch.float32)
    args, idx, cfg, sub = mixed_exact_args(run)
    before = tracer.EXACT_LAUNCHES
    kern = tracer._exact_run(*args)
    check(tracer.EXACT_LAUNCHES == before + 1,
          "mixed exact_run did not launch once")
    trunc = int(kern.trunc.sum())
    capped = (kern.lane_att == MAX_ITERS).any(dim=0)
    check(trunc == 0, f"mixed exact_run over {MIXED_README_DAYS} days: "
          f"{trunc} truncated lane-groups (lanes at the backstop "
          f"{capped.nonzero().flatten().tolist()})")
    ms = cuda_ms(lambda: tracer._exact_run(*args), 3)
    tag = "mixed exact_run"

    def launch(inst, args=args, **kw):
        return tracer._exact_run_cuda(*args, instance=inst, **kw)

    def same_as(out, ref=kern):
        return (all(same(getattr(out, n), getattr(ref, n))
                    for n in ("ys", "ugs", "vgs", "lane_att", "trunc"))
                and all(same(a, b) for a, b in zip(out.carry, ref.carry)))

    in_turns(run, tag, launch, 3, same_as)
    print_choice(run, tag, rk45.exact_instance(args[1].shape[1], key))
    # The plain comparison on a subset: EXACT_SUBSET lanes, EXACT_DAYS days.
    plain, plain_ms = plain_call(run, tag, "_exact_run_plain", *sub)
    for inst in kernels.INSTANCES:
        check(same_as(launch(inst, sub), plain),
              f"{tag}: instance {inst} differs from the plain run")
    # The barrier flag: one bound per group over BARRIER_DAYS days, every
    # 7th lane's amp at float64's largest value.
    y0 = sub[1].clone()
    y0[4, ::7] = torch.finfo(f64).max
    f0 = ray.RayRHS(sub[0])(y0)
    n_b = int(BARRIER_DAYS * DAY / cfg.tstep)
    one = tracer.padded_bounds(rk45.as_scalar(cfg.tstep, f64), n_b + 1, 1,
                               f64, run.dev)
    bargs = (sub[0], y0, *sub[2:5], f0, one, n_b, *sub[8:])
    bplain = tracer._exact_run_plain(*bargs, 100_000, barrier=True)
    for inst in kernels.INSTANCES:
        check(same_as(launch(inst, bargs, max_iters=100_000, barrier=True),
                      bplain),
              f"{tag}: barrier kernel, instance {inst}, differs from the "
              "flagged plain run")
    trips = kern.lane_att.sum(dim=0)
    attempts = int(kern.lane_att.sum())
    bnd = exact_bound(args, kern[:5] + kern.carry, "mixed", attempts,
                      int(kern.ugs[1:].isfinite().sum()))
    print(f"{tag}: R={args[1].shape[1]}, {kern.ys.shape[0] - 1} bounds "
          f"({MIXED_README_DAYS} days) in {kern.lane_att.shape[0]} groups, "
          f"no truncated lane-group; kernel {ms:.3f} ms (CUDA events), bound "
          f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']}); step attempts "
          f"{attempts}, most trips per group "
          f"{kern.lane_att.amax(dim=1).tolist()}, longest lane "
          f"{int(trips.max())} trips in all; every instance bitwise equal to "
          f"the plain run on {EXACT_SUBSET} lanes x {EXACT_DAYS} days (plain "
          f"{plain_ms:.1f} ms) and, with the barrier flag, to the flagged "
          f"plain run over {BARRIER_DAYS} days")
    traj, launches, wall, peak, stats, refused = traced(run, mixed(cfg),
                                                        "exact_run")
    check(refused is None, f"the mixed README run was refused: {refused}")
    all_float64(traj, "mixed exact trace_rays")
    check_rows(traj, idx, kern, tag)
    check(torch.equal(stats["lane_att"], kern.lane_att),
          f"{tag}: trace_rays' attempts differ from the kernel's")
    print(f"{tag} trace_rays: {traj.lon[0].numel()} rays x {cfg.nt - 1} "
          f"bounds, wall {wall:.3f} s, peak device memory {peak:.1f} MiB "
          f"above the prepared state; launches {launches}; float64 outputs, "
          "rows bitwise equal to the kernel's")
    run.kernels["exact_run_mix"] = dict(
        max_abs_err=0.0, ms=ms, plain_ms=plain_ms, library_ms=None, **bnd)
    run.launches["exact_run_mix"] = launches["exact_run"]
    run.launches["exact_group_mix"] = launches["exact_group"]
    run.mixed_exact = (idx, kern)


# ---- Time-varying backgrounds and ensembles (the time instances) ----


class captured:
    """Within the block, ``tracer.<name>`` (a whole-run unit) is a wrapper
    that records each call's arguments, its result and the device time
    between CUDA events around it (the one launch and its small
    allocations); ``calls`` holds (args, kwargs, result, ms)."""

    def __init__(self, run, name):
        self.run, self.name, self.calls = run, name, []

    def __enter__(self):
        from rwrt_tpu_torch import tracer

        torch = self.run.torch
        self.unit = unit = getattr(tracer, self.name)
        events = self.events = []

        def wrapper(*a, **k):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = unit(*a, **k)
            end.record()
            events.append((a, k, out, start, end))
            return out

        setattr(tracer, self.name, wrapper)
        return self

    def __exit__(self, *exc):
        from rwrt_tpu_torch import tracer

        setattr(tracer, self.name, self.unit)
        self.run.torch.cuda.synchronize()
        self.calls = [(a, k, out, s.elapsed_time(e))
                      for a, k, out, s, e in self.events]
        return False


def lane_pick(args, take):
    """A whole-run unit's arguments cut to the lanes ``take`` (an index
    tensor): every tensor whose last dimension is the lanes', and an
    ensemble background's member map."""
    bg, r = args[0], args[1].shape[1]
    if bg.member_ids is not None:
        bg = bg._replace(member_ids=bg.member_ids.index_select(0, take))
    return (bg,) + tuple(
        a.index_select(a.ndim - 1, take).contiguous()
        if hasattr(a, "shape") and a.ndim and a.shape[-1] == r else a
        for a in args[1:])


def groups_of(args, n):
    """A grouped unit's arguments cut to its first n groups."""
    bounds_g = args[6][:n].contiguous()
    return args[:6] + (bounds_g, bounds_g.numel()) + args[8:]


def subset_of(run, r, n):
    """n lanes of r: the first n, or for an ensemble every r // n-th, so
    that every member has some."""
    torch = run.torch
    step = max(r // n, 1)
    return torch.arange(0, step * n, step, device=run.dev)[:n]


def equal_runs(k, p, what):
    """Two grouped runs (``tracer.GroupedRun``) equal to the bit."""
    for name in ("ys", "ugs", "vgs", "lane_att", "trunc"):
        check(same(getattr(k, name), getattr(p, name)),
              f"{what}: {name} differs from the plain run")
    for a, b in zip(k.carry, p.carry):
        check(same(a, b), f"{what}: carry differs from the plain run")


def tv_state(run, n_frames, dtype=None, scale=1.0, phase=0.0):
    """The time-varying climatology of ``n_frames`` daily frames from day
    0 on the card (float32 unless ``dtype``)."""
    fu, fv, lat, lon = climatology_frames(n_frames, scale, phase)
    return run.rt.prepare_time_varying(
        fu, fv, lat, lon, bg_t0=0.0, bg_dt=DAY,
        cal_dtype=dtype or run.torch.float32, device=run.dev)


def phase_time_rhs(run):
    """The RHS kernel's time instance on 100,800 seeded states at per-lane
    times over every frame, between them and past both ends, over the
    TV_DAYS-day daily-frame background, a 4-member ensemble and a 4-member
    ensemble of those frames: bitwise equal to the plain ``_rhs_core``, in
    float32 and float64."""
    torch = run.torch
    from rwrt_tpu_torch import tracer
    from rwrt_tpu_torch.models import ray

    rng = np.random.default_rng(1)
    n = 100_800
    y = np.stack([rng.uniform(-1.0, 7.3, n), rng.uniform(-1.65, 1.65, n),
                  rng.uniform(0.5, 7.5, n), rng.normal(0.0, 40.0, n),
                  rng.uniform(0.5, 2.0, n)])
    for row in (0, 3, 4):
        y[row, rng.choice(n, 500, replace=False)] = np.nan
    t = rng.uniform(-2.0 * DAY, (TV_DAYS + 3) * DAY, n)
    t[:1000] = DAY * (np.arange(1000) % (TV_DAYS + 1))  # on the frames
    member = torch.as_tensor(rng.integers(0, 4, n), dtype=torch.int32,
                             device=run.dev)
    for dtype in (torch.float32, torch.float64):
        tv = tracer.make_background(tv_state(run, TV_DAYS + 1, dtype), 0.0)
        years = [tracer.make_background(
            tv_state(run, TV_DAYS + 1, dtype, sc, ph), 0.0)
            for sc, ph in zip(MEMBER_SCALES, MEMBER_PHASES)]
        kinds = {
            "time": tv,
            "member": tv._replace(fields=torch.stack(
                [b.fields[0] for b in years]).contiguous(),
                member_ids=member),
            "member_time": tv._replace(fields=torch.stack(
                [b.fields for b in years]).contiguous(), member_ids=member)}
        yt = torch.as_tensor(y, dtype=dtype, device=run.dev).contiguous()
        tt = torch.as_tensor(t, dtype=dtype, device=run.dev)
        for kind, bg in kinds.items():
            for gv in (False, True):
                before = ray.LAUNCHES
                k = ray.rhs_and_gv(bg, yt, tt) if gv else ray.rhs(bg, yt, tt)
                check(ray.LAUNCHES == before + 1, "rhs did not launch")
                p = ray._rhs_core(bg, yt, tt, gv)
                p = (p[0], p[2], p[3]) if gv else p[:2]
                for a, b in zip(k, p):
                    check(same(a, b) if a.is_floating_point()
                          else torch.equal(a, b),
                          f"time_rhs {kind} {dtype} gv={gv}: differs from "
                          "the plain RHS")
        print(f"time_rhs {str(dtype)[6:]}: R={n}, time, member and "
              f"member x time backgrounds ({tuple(bg.fields.shape)}), rhs "
              "and rhs_and_gv bitwise equal to the plain RHS")
        if dtype == torch.float32:
            bg = kinds["time"]
            ms = cuda_ms(lambda: ray.rhs(bg, yt, tt), 20)
            plain = cuda_ms(lambda: ray._rhs_core(bg, yt, tt, False), 5)
            b = bound(2 * nbytes(yt) + nbytes(tt) + n
                      + sampled_bytes(bg, ((yt[0], yt[1], tt),)),
                      n * (RHS_FLOPS + TIME_SAMPLE_FLOPS), "float32")
            print(f"time_rhs time at R={n} over {bg.fields.shape[0]} "
                  f"frames: kernel {ms:.4f} ms, plain {plain:.4f} ms, bound "
                  f"{b['bound_ms']:.4f} ms ({b['bound_by']})")
            run.kernels["rhs_time"] = dict(max_abs_err=0.0, ms=ms,
                                           plain_ms=plain, library_ms=None,
                                           **b)


def grouped_bound(args, out, attempts_flops, rows_flops, row_samples):
    """A grouped run's bound: its inputs and outputs once; flops: each
    attempt's ``attempts_flops`` and each kept row's ``rows_flops`` (dicts
    by unit) plus ``time_sample_flops`` for each of the attempt's six
    evaluations and, with ``row_samples`` (the dense run's post-pass),
    each row's (ug, vg) sample, in the background's type."""
    bg, y0, ug0, vg0, h0, f0, bounds_g = args[:7]
    rows = int(out.ys[1:, 0].isfinite().sum())
    attempts = int(out.lane_att.sum())
    flops = {u: attempts * n for u, n in attempts_flops.items()}
    for u, n in rows_flops.items():
        flops[u] = flops.get(u, 0) + rows * n
    dtype = str(bg.fields.dtype)[6:]
    flops[dtype] = (flops.get(dtype, 0) + (6 * attempts + rows * row_samples)
                    * time_sample_flops(bg))
    return bound(nbytes(bg.fields, y0, ug0, vg0, h0, f0, bounds_g, out.ys,
                        out.ugs, out.vgs, out.lane_att, out.trunc,
                        *out.carry), flops), attempts


def group_entry(unit, sub, kw, g):
    """A grouped unit's arguments ``sub`` over its group g alone: as given
    for g = 0, else entered from the carry of ``unit`` over groups 0..g-1
    at the carry's times, as the chunked driver enters a chunk. Returns
    (args, kwargs, the full run's row of the group's row 0)."""
    if g == 0:
        return groups_of(sub, 1), kw, 0
    head = unit(*groups_of(sub, g), **kw)
    y, t, h, f = head.carry[:4]
    bounds_g = sub[6]
    row = g * bounds_g.shape[1]
    n_bounds = min(sub[7] - row, bounds_g.shape[1])
    return ((sub[0], y, head.ugs[row], head.vgs[row], h, f,
             bounds_g[g:g + 1].contiguous(), n_bounds) + sub[8:],
            dict(kw, t0=t), row)


def plain_check(run, unit_name, args, kw, out, n_lanes, groups, what,
                stage=False):
    """The whole-run unit's kernel on n_lanes lanes of its arguments over
    each of ``groups``, entered as ``group_entry`` enters it, against its
    plain version there (with ``stage``, the groups' plain runs side by
    side in a plain stage), bitwise, and against the full run's rows of
    those lanes; returns the plain runs' ms."""
    from rwrt_tpu_torch import tracer

    unit = getattr(tracer, unit_name)
    take = subset_of(run, args[1].shape[1], n_lanes)
    sub = lane_pick(args, take)
    entries = [group_entry(unit, sub, kw, g) for g in groups]
    fn = unit_name + "_plain"
    if stage:
        wall = plain_stage(run, [(f"{what} group {g}", 1.0, fn, a, k_kw)
                                 for g, (a, k_kw, _) in zip(groups, entries)])
        print(f"{what}: plain stage of {len(entries)} groups, {wall:.1f} s")
    ms = 0.0
    for g, (a, k_kw, row) in zip(groups, entries):
        k = unit(*a, **k_kw)
        p, p_ms = plain_call(run, f"{what} group {g}", fn, *a, **k_kw)
        ms += p_ms
        equal_runs(k, p, f"{what} group {g}")
        # Row 0 is the entry state: past g = 0 the carry, which dense mode
        # holds at its last step's end, beyond the full run's row there.
        rows = slice(row + 1, row + k.ys.shape[0])
        for name in ("ys", "ugs", "vgs"):
            full = getattr(out, name)[rows].index_select(-1, take)
            check(same(getattr(k, name)[1:], full),
                  f"{what} group {g}: the lane subset's {name} differ from "
                  "the full run's")
    return ms


def stack_of(bg):
    """A time or member background's stack in words."""
    members = bg.member_ids is not None
    frames = bg.fields.ndim == 5 or not members
    return " x ".join(
        ([f"{bg.fields.shape[0]} members"] if members else [])
        + ([f"{bg.fields.shape[-4]} frames"] if frames else []))


def run_record(run, key, what, traj_call, unit_name, of, attempts_flops,
               rows_flops, n_plain_lanes=TV_PLAIN_LANES, every_group=False):
    """A time-varying grouped run through its entry point (``traj_call``,
    returning ``traced``'s tuple) with ``tracer.<unit_name>`` captured:
    the traced run's one launch of ``of``, its kernel re-timed on the same
    entry state, a lane subset over the first and the last group (or
    ``every_group``) bitwise against the plain version, the bound; recorded
    under ``key``. Returns (traj, args, kw, out, a record of the wall, peak
    memory, kernel ms, attempts and launches)."""
    with captured(run, unit_name) as cap:
        traj, launches, wall, peak, stats, refused = traj_call()
    check(refused is None, f"{what} was refused: {refused}")
    check(len(cap.calls) == 1, f"{what}: {len(cap.calls)} unit calls")
    args, kw, out, first_ms = cap.calls[0]
    from rwrt_tpu_torch import tracer

    unit = getattr(tracer, unit_name)
    ms = cuda_ms(lambda: unit(*args, **kw), 2)
    n_groups = args[6].shape[0]
    groups = range(n_groups) if every_group else sorted({0, n_groups - 1})
    # Every group: the plain runs side by side in a plain stage.
    plain_ms = plain_check(run, unit_name, args, kw, out, n_plain_lanes,
                           groups, what, stage=every_group)
    b, attempts = grouped_bound(args, out, attempts_flops, rows_flops,
                                unit_name == "_dense_run")
    trips = out.lane_att.sum(dim=0)
    print(f"{what}: R={args[1].shape[1]} lanes, {out.ys.shape[0] - 1} bounds "
          f"over {stack_of(args[0])}; wall {wall:.3f} s, "
          f"peak device memory {peak:.1f} MiB above the prepared state, "
          f"launches {launches}; kernel {ms:.3f} ms (first call "
          f"{first_ms:.3f} ms), bound {b['bound_ms']:.4f} ms "
          f"({b['bound_by']}); step attempts {attempts}, longest lane "
          f"{int(trips.max())} trips; {n_plain_lanes} lanes x groups "
          f"{list(groups)} of {n_groups} bitwise equal to the plain run "
          f"({plain_ms:.1f} ms) and to the full run's rows")
    run.kernels[key] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                            library_ms=None, **b)
    if unit_name == "_dense_run":
        rec = dense_report(run, what, args, kw, out)
        run.kernels[key]["chain_floor_ms"] = rec["chain_floor_ms"]
    run.launches[key] = launches[of]
    return traj, args, kw, out, dict(wall=wall, peak=peak, ms=ms,
                                      attempts=attempts, launches=launches)


def rk4_record(run, key, what, traj_call):
    """A time-varying or ensemble RK4 run through its entry point
    (``traj_call``, returning ``traced``'s tuple) with ``tracer._run_rk4``
    captured: its one launch, the kernel re-timed on the same entry state,
    TV_PLAIN_LANES lanes over the run's first and last TV_PLAIN_STEPS steps
    (the last entered from the full run's row, at its time) bitwise against
    the plain loop and the full run's rows, the bound; recorded under
    ``key``. Returns the trajectory."""
    torch = run.torch
    from rwrt_tpu_torch import kernels, tracer
    from rwrt_tpu_torch.solvers import rk4

    with captured(run, "_run_rk4") as cap:
        traj, launches, wall, peak, _, _ = traj_call()
    check(len(cap.calls) == 1, f"{what}: {len(cap.calls)} unit calls")
    args, _, out, _ = cap.calls[0]
    bg, y0, ug0, vg0, dt, nt, cut_off = args
    ms = cuda_ms(lambda: tracer._run_rk4(*args), 2)
    take = subset_of(run, y0.shape[1], TV_PLAIN_LANES)
    bsub, ysub = lane_pick(args[:2], take)
    plain_ms = 0.0
    for s0 in (0, nt - 1 - TV_PLAIN_STEPS):
        y = ysub if s0 == 0 else out[0][s0].index_select(1, take).contiguous()
        t_start = s0 * float(dt)
        _, k = tracer._rk4_chunk(bsub, y, dt, TV_PLAIN_STEPS, cut_off,
                                 t_start)
        p = tracer._rk4_buffers(y, TV_PLAIN_STEPS)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        rk4.trace_into(bsub, y, dt, TV_PLAIN_STEPS, cut_off, *p,
                       t_start=t_start)
        end.record()
        torch.cuda.synchronize()
        plain_ms += start.elapsed_time(end)
        rows = slice(s0 + 1, s0 + 1 + TV_PLAIN_STEPS)
        for a, b_, c in zip(k, p, out):
            check(same(a, b_), f"{what}: steps {s0 + 1}.. of the lane subset "
                  "differ from the plain run")
            check(same(a, c[rows].index_select(-1, take)),
                  f"{what}: steps {s0 + 1}.. of the lane subset differ from "
                  "the full run")
    key_dt = kernels.state_key(y0, bg.fields)
    b = rk4_bound(bg, y0, ug0, vg0, out,
                  "mixed" if key_dt[0] != key_dt[1] else y0.dtype)
    print(f"{what}: R={y0.shape[1]}, {nt - 1} steps over {stack_of(bg)}; "
          f"wall {wall:.3f} s, peak device memory {peak:.1f} MiB, launches "
          f"{launches}; kernel {ms:.3f} ms, bound {b['bound_ms']:.4f} ms "
          f"({b['bound_by']}); {TV_PLAIN_LANES} lanes x the first and last "
          f"{TV_PLAIN_STEPS} steps bitwise equal to the plain run "
          f"({plain_ms:.1f} ms) and to the full run; instance "
          f"{tracer.rk4_instance(y0.shape[1], key_dt, '_time')}")
    run.kernels[key] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                            library_ms=None, **b)
    run.launches[key] = launches["rk4_run"]
    return traj


def phase_time_main_path(run):
    """The production run on the TV_DAYS-day daily-frame background
    through ``trace_rays`` (counters reset just before it and read just
    after): one whole-run launch of the dense kernel's time instance; its
    first N_SUBSET lanes over every group bitwise against
    ``_dense_run_plain`` on the same entry state; kernel ms and wall beside
    the static run's."""
    torch = run.torch
    bs = tv_state(run, TV_DAYS + 1)
    run.tv_bs = bs
    cfg = production_config(run.rt)
    src = dict(source_lon=run.slon, source_lat=run.slat)
    rows = {"float32": ROW_FLOPS + CASCADE_FLOPS}
    attempts = {"float32": ATTEMPT_FLOPS}
    traj, args, kw, out, rec = run_record(
        run, "dense_run_time", "time_main_path",
        lambda: traced(run, cfg, "dense_run", bs=bs, **src), "_dense_run",
        "dense_run", attempts, rows, N_SUBSET, every_group=True)
    # The traced run's entry stage (h0 and f0) is the time instance's.
    launches = rec["launches"]
    run.launches["entry_time"] = launches["entry"]
    run.tv_entry = (args[0], args[1])
    nt = cfg.nt
    alive = float(torch.isfinite(traj.ky[-1]).float().mean())
    static = run.kernels["dense_run"]["ms"]
    print(f"time_main_path: {3 * N_SOURCES * 7} rays x {N_DAYS} days, kernel "
          f"{rec['ms']:.3f} ms against the static run's {static:.3f} ms "
          f"({rec['ms'] / static:.3f} x), wall {rec['wall']:.3f} s against "
          f"{run.main_wall:.3f} s, step attempts {rec['attempts']} (static "
          f"{DENSE_ATTEMPTS}), alive fraction at day {N_DAYS} {alive:.4f}, "
          f"entry launches {launches['entry']}, rhs launches "
          f"{launches['rhs']}")
    lon10, lat10 = traj.lon[120].reshape(-1), traj.lat[120].reshape(-1)
    fin = torch.isfinite(lon10) & torch.isfinite(lat10)
    run.tv_day10 = (lon10[fin].contiguous(), lat10[fin].contiguous())
    run.tv_dense = (traj, args[0].fields.shape)
    check(tuple(traj.lon.shape) == (nt, 3, N_SOURCES, 7), "shape")


def in_float64(cfg):
    """``cfg`` over a float64 background."""
    return dataclasses.replace(cfg, cal_dtype="float64")


def phase_time_paths(run):
    """The other branches over the daily-frame background, each through
    ``trace_rays`` with one launch of its kernel's time instance: RK4 in
    ``RunConfig()``'s default run (LONG_DAYS days, LONG_DAYS + 1 frames) in
    float32, mixed precision and float64; the README exact run in float32
    (README_DAYS days), mixed precision and float64 (LONG_DAYS days); the
    dense production run in mixed precision and float64 (N_DAYS days). A
    lane subset of each, over its first and last group (steps in RK4),
    bitwise against the plain version; kernel ms and bound."""
    f64 = run.torch.float64
    bs90 = tv_state(run, LONG_DAYS + 1)
    bs90_f64 = tv_state(run, LONG_DAYS + 1, f64)
    run.tv_bs90 = bs90
    cfg = dataclasses.replace(default_config(run.rt), ttotal=LONG_DAYS * DAY)
    for key, c, bs in (("rk4_run_time", cfg, bs90),
                       ("rk4_run_time_mix", mixed(cfg), bs90),
                       ("rk4_run_time_f64", in_float64(cfg), bs90_f64)):
        what = f"time_paths rk4 default {key[13:] or 'f32'}"
        traj = rk4_record(run, key, what,
                          lambda: traced(run, c, "rk4_run", bs=bs))
        if key.endswith(("mix", "f64")):
            all_float64(traj, f"time {key}")

    exact_f32 = ({"float32": EXACT_ATTEMPT_FLOPS}, {"float32": KILL_FLOPS})
    exact_f64 = ({"float64": EXACT_ATTEMPT_FLOPS}, {"float64": KILL_FLOPS})
    exact_mix = (MIX_EXACT_ATTEMPT_FLOPS, {"float64": KILL_FLOPS})
    for key, c, bs, flops in (
            ("exact_run_time", readme_config(run.rt), bs90, exact_f32),
            ("exact_run_time_mix", mixed(readme_config(run.rt, LONG_DAYS)),
             bs90, exact_mix),
            ("exact_run_time_f64",
             in_float64(readme_config(run.rt, LONG_DAYS)), bs90_f64,
             exact_f64)):
        traj, *_ = run_record(
            run, key, f"time_paths readme exact {key[15:] or 'f32'}",
            lambda: traced(run, c, "exact_run", bs=bs), "_exact_run",
            "exact_run", *flops)
        if key.endswith(("mix", "f64")):
            all_float64(traj, f"time {key}")

    src = dict(source_lon=run.slon, source_lat=run.slat)
    rows = ROW_FLOPS + CASCADE_FLOPS
    for key, c, bs, flops in (
            ("dense_run_time_mix", mixed(production_config(run.rt)),
             run.tv_bs, (MIX_ATTEMPT_FLOPS, {"float64": rows})),
            ("dense_run_time_f64", in_float64(production_config(run.rt)),
             tv_state(run, TV_DAYS + 1, f64),
             ({"float64": ATTEMPT_FLOPS}, {"float64": rows}))):
        # The float64 history (4.1 GB) is past trace_rays' reroute
        # estimate; the card holds it, and the run stays one launch.
        traj, *_ = run_record(
            run, key, f"time_paths production dense {key[15:]}",
            lambda: traced(run, c, "dense_run", bs=bs, auto_chunk_bytes=None,
                           **src), "_dense_run", "dense_run", *flops)
        all_float64(traj, f"time {key}")
        del traj


def phase_time_chunked(run):
    """The chunked driver on the daily-frame background: the N_DAYS-day
    production run in chunks of CHUNK_STEPS, one launch each, rows bitwise
    equal to time_main_path's; the LONG_DAYS-day one through
    ``trace_rays``, which reroutes to the driver, with the wall's split."""
    from rwrt_tpu_torch.utils import checkpoint

    src = dict(source_lon=run.slon, source_lat=run.slat)
    cfg = production_config(run.rt)
    n_chunks = -(-(cfg.nt - 1) // CHUNK_STEPS)
    traj, launches, wall, peak, stats, _ = traced(
        run, cfg, "dense_run", n_chunks, checkpoint.trace_rays_chunked,
        bs=run.tv_bs, chunk_steps=CHUNK_STEPS, verbose=False, **src)
    ref, _ = run.tv_dense
    for k in ref._fields:
        check(same(getattr(traj, k), getattr(ref, k).cpu()),
              f"time_chunked: {k} differs from the one-launch run")
    print(f"time_chunked {N_DAYS} days: {n_chunks} chunks of {CHUNK_STEPS}, "
          f"launches {launches}, wall {wall:.3f} s, kernel "
          f"{sum(stats['chunk_ms']):.3f} ms in all; rows bitwise equal to "
          "the one-launch run's")
    del traj
    cfg90 = production_config(run.rt, ttotal=LONG_DAYS * DAY)
    n90 = -(-(cfg90.nt - 1) // DEFAULT_CHUNK_STEPS)
    traj, launches, wall, peak, stats, refused = traced(
        run, cfg90, "dense_run", n90, bs=run.tv_bs90, **src)
    check(refused is None and traj.lon.device.type == "cpu",
          f"the {LONG_DAYS}-day time-varying trace_rays did not reroute")
    alive_end = traj.ky[-1].isfinite()
    for k in traj._fields:
        check(bool(getattr(traj, k)[-1][alive_end].isfinite().all()),
              f"time {LONG_DAYS} days: non-finite {k} on a live lane")
    kernel_s = sum(stats["chunk_ms"]) / 1e3
    host = stats["seconds"]
    split = dict(wall=wall, kernel=kernel_s, **host,
                 other=wall - kernel_s - sum(host.values()))
    print(f"time_chunked {LONG_DAYS} days through trace_rays (rerouted): "
          f"{n90} chunks of {DEFAULT_CHUNK_STEPS} over "
          f"{run.tv_bs90.fields.shape[0]} frames, launches {launches}, "
          f"peak device memory {peak:.1f} MiB above the prepared state, "
          f"alive fraction at the end {float(alive_end.float().mean()):.4f}")
    print(f"time_chunked {LONG_DAYS} days wall split (s): "
          + json.dumps(split))


def members_equal_own_runs(run, members, cfg, ens, of, what, **kw):
    """Each member's rows of an ensemble run bitwise equal to its own
    ``trace_rays``, one launch of ``of`` each."""
    for i, (bs, traj) in enumerate(zip(members, ens)):
        own, launches, *_ = traced(run, cfg, of, bs=bs, **kw)
        for k in own._fields:
            check(same(getattr(own, k), getattr(traj, k)),
                  f"{what}: member {i}'s {k} differs from its own run")


def phase_ensemble(run):
    """``trace_rays_ensemble`` on the card: four "reanalysis year" members
    (static climatologies, each its jet scale and wave phase) x the
    production seeding (403,200 rays), N_DAYS days, dense with pin, float32:
    one launch of the dense kernel's time instance with the member map,
    each member's rows bitwise equal to its own ``trace_rays``, a lane
    subset over every member and the first and last group bitwise against
    the plain run, kernel ms and peak memory; then two time-varying
    members (TV_DAYS + 1 frames) over the README's sources, the same way:
    in RK4 (float32) and in exact mode (float64, where the time carry does
    not stall)."""
    torch = run.torch
    fr = [climatology_frames(1, sc, ph)
          for sc, ph in zip(MEMBER_SCALES, MEMBER_PHASES)]
    years = [run.rt.prepare(u[0], v[0], lat, lon, device=run.dev)
             for u, v, lat, lon in fr]
    cfg = production_config(run.rt)
    src = dict(source_lon=run.slon, source_lat=run.slat)
    driver = run.rt.trace_rays_ensemble
    ens, args, kw, out, rec = run_record(
        run, "dense_run_member", "ensemble 4 members dense",
        lambda: traced(run, cfg, "dense_run", driver=driver, bs=years,
                       **src), "_dense_run", "dense_run",
        {"float32": ATTEMPT_FLOPS}, {"float32": ROW_FLOPS + CASCADE_FLOPS})
    members_equal_own_runs(run, years, cfg, ens, "dense_run",
                           "ensemble dense", **src)
    print(f"ensemble: {len(years)} members x {3 * N_SOURCES * 7} rays, "
          f"{args[1].shape[1]} lanes after compaction; kernel "
          f"{rec['ms']:.3f} ms, peak device memory {rec['peak']:.1f} MiB "
          "above the prepared state; every member's rows bitwise equal to "
          "its own trace_rays")
    run.ensemble = (years, ens, out.lane_att)
    del ens

    tv = [tv_state(run, TV_DAYS + 1, None, sc, ph)
          for sc, ph in zip(MEMBER_SCALES[:2], MEMBER_PHASES[:2])]
    cfg = dataclasses.replace(default_config(run.rt), ttotal=TV_DAYS * DAY)
    ens = rk4_record(run, "rk4_run_member_time", "ensemble rk4",
                     lambda: traced(run, cfg, "rk4_run", driver=driver,
                                    bs=tv))
    members_equal_own_runs(run, tv, cfg, ens, "rk4_run", "ensemble rk4")
    print(f"ensemble rk4: {len(tv)} time-varying members; every member's "
          "rows bitwise equal to its own trace_rays")

    # Exact mode in float64: in float32 the time carry stalls lanes at the
    # backstop (ROADMAP Queue 3), and an ensemble runs in its fields' type.
    tv = [tv_state(run, TV_DAYS + 1, torch.float64, sc, ph)
          for sc, ph in zip(MEMBER_SCALES[:2], MEMBER_PHASES[:2])]
    cfg = readme_config(run.rt, TV_DAYS)
    ens, *_ = run_record(
        run, "exact_run_member_time_f64", "ensemble exact float64",
        lambda: traced(run, cfg, "exact_run", driver=driver, bs=tv),
        "_exact_run", "exact_run", {"float64": EXACT_ATTEMPT_FLOPS},
        {"float64": KILL_FLOPS})
    members_equal_own_runs(run, tv, cfg, ens, "exact_run", "ensemble exact")


#: The mesh phase's shards: entries that all name the one card, the port's
#: form of the JAX package's virtual devices. 60,784 production lanes, 4,288
#: default-run lanes and 243,016 ensemble lanes each pad by 2.
MESH_SHARDS = 3
#: The order in which the dense production run is timed without and with
#: the mesh.
MESH_TURNS = ("meshless", "mesh", "mesh", "meshless") * 2


def mesh_launches(of, chunks=1):
    """The launches of a run over the MESH_SHARDS-entry mesh: one launch of
    ``of`` per shard (per chunk) and, for an adaptive run, one entry-stage
    launch per shard."""
    want = {of: MESH_SHARDS * chunks}
    if of in ("dense_run", "exact_run"):
        want["entry"] = MESH_SHARDS
    return want


def phase_mesh(run):
    """The device mesh (``parallel.sharding``) on the card: every run over
    ``Mesh((cuda:0,) * MESH_SHARDS)``, counters reset just before each and
    read just after (one whole-run launch per shard, an adaptive run's
    entry stage once per shard, nothing else), its rows bitwise the rows
    the earlier phases hold of the same run without a mesh: the dense
    production run (rows, (ug, vg) and attempts main_path's; its wall and
    the meshless run's in turns, the split's host cost on one card) and its
    mixed precision (mixed_dense's), the RK4 default run (rk4_path's), the
    README exact run (exact_path's), the 4-member ensemble (ensemble's);
    the production run in chunks of CHUNK_STEPS cut by a two-chunk budget
    with a checkpoint, refused on resume under a mesh of MESH_SHARDS + 1,
    resumed under its own (main_path's rows); the wavenumber maps
    (bitwise the meshless maps); and a CLI_SHORT_DAYS-day CLI run with
    --wnmaps, with and without --mesh (a mesh of the card count): its
    files bitwise, its report's "mesh" {"rays": 1}."""
    import os

    torch = run.torch
    rt = run.rt
    from rwrt_tpu_torch.diagnostics import compute_wavenumber_maps
    from rwrt_tpu_torch.parallel.sharding import Mesh
    from rwrt_tpu_torch.utils import checkpoint

    mesh = Mesh((run.dev,) * MESH_SHARDS)
    src = dict(source_lon=run.slon, source_lat=run.slat)
    cfg = production_config(rt)
    bs = run.bs(torch.float32)

    # The dense production run, meshless and meshed in turns.
    walls = []
    for name in MESH_TURNS:
        kw = dict(src, mesh=mesh) if name == "mesh" else src
        of = mesh_launches("dense_run") if name == "mesh" else "dense_run"
        traj, launches, wall, peak, stats, refused = traced(
            run, cfg, of, bs=bs, **kw)
        check(refused is None, f"mesh production ({name}) was refused")
        for k in traj._fields:
            check(same(getattr(traj, k), getattr(run.main_traj, k)),
                  f"mesh production ({name}): {k} differs from main_path's")
        check(torch.equal(stats["lane_att"], run.main_att),
              f"mesh production ({name}): attempts differ from main_path's")
        walls.append((name, wall, peak, launches))
        if name == "mesh":
            shard_iters = stats["shard_iters"]
    del traj
    median = {n: float(np.median([w for m, w, _, _ in walls if m == n]))
              for n in ("meshless", "mesh")}
    print(f"mesh production: {3 * N_SOURCES * 7} rays, 60,784 lanes over "
          f"{MESH_SHARDS} shards of one card; walls in turns (s) "
          + json.dumps([(n, round(w, 6)) for n, w, _, _ in walls])
          + f", median meshless {median['meshless']:.6f}, mesh "
          f"{median['mesh']:.6f}; peak device memory above the prepared "
          "state (MiB) "
          + json.dumps([(n, round(p, 1)) for n, _, p, _ in walls])
          + f"; launches {walls[1][3]}; per-shard attempts in all "
          f"{shard_iters.sum(dim=1).tolist()}; rows, (ug, vg) and "
          "attempts bitwise main_path's")
    # The whole-run kernel on the run's entry state, whole and per shard
    # (CUDA events): the shards' launches run one after another here.
    from rwrt_tpu_torch import tracer
    from rwrt_tpu_torch.parallel import sharding

    bg, args, kw, _ = run.run_inputs(torch.float32)
    whole_ms = cuda_ms(lambda: tracer._dense_run(*args, **kw), 3)
    parts = [sharding.shard_rays(sharding.pad_rays(x, MESH_SHARDS)[0], mesh)
             for x in args[1:6]]
    shard_ms = [cuda_ms(lambda i=i: tracer._dense_run(
        bg, *(p[i] for p in parts), *args[6:], **kw), 3)
        for i in range(MESH_SHARDS)]
    split_ms = cuda_ms(lambda: tracer._run_sharded(
        mesh, bg, args[1:6],
        lambda b, *lanes: tracer._dense_run(b, *lanes, *args[6:], **kw)), 3)
    print(f"mesh production kernel (CUDA events): whole batch "
          f"{whole_ms:.3f} ms; shards "
          f"{[round(x, 3) for x in shard_ms]} ms, sum {sum(shard_ms):.3f}; "
          f"the split run (pad, split, 3 launches) {split_ms:.3f} ms")
    del parts

    traj, launches, wall, _, stats, _ = traced(
        run, mixed(cfg), mesh_launches("dense_run"), bs=bs, mesh=mesh, **src)
    idx, kern = run.mixed_dense
    all_float64(traj, "mesh mixed dense")
    check_rows(traj, idx, kern, "mesh mixed dense")
    check(torch.equal(stats["lane_att"], kern.lane_att),
          "mesh mixed dense: attempts differ from mixed_dense's")
    print(f"mesh mixed dense: wall {wall:.3f} s, launches {launches}; rows "
          "and attempts bitwise mixed_dense's")
    del traj

    traj, launches, wall, _, _, _ = traced(
        run, default_config(rt), mesh_launches("rk4_run"), bs=bs, mesh=mesh)
    check_rows(traj, *run.rk4["default"], "mesh rk4 default")
    print(f"mesh rk4 default: 6,615 rays, 4,288 lanes, wall {wall:.3f} s, "
          f"launches {launches}; rows bitwise rk4_path's")

    traj, launches, wall, _, stats, refused = traced(
        run, readme_config(rt), mesh_launches("exact_run"), bs=bs,
        mesh=mesh)
    check(refused is None, f"mesh README run was refused: {refused}")
    idx, kern = run.exact_run
    check_rows(traj, idx, kern, "mesh exact")
    check(torch.equal(stats["lane_att"], kern.lane_att),
          "mesh exact: attempts differ from exact_path's")
    print(f"mesh exact: the README run to {README_DAYS} days, wall "
          f"{wall:.3f} s, launches {launches}; rows and attempts bitwise "
          "exact_path's")
    del traj

    years, ens, ens_att = run.ensemble
    got, launches, wall, _, stats, refused = traced(
        run, cfg, mesh_launches("dense_run"), driver=rt.trace_rays_ensemble,
        bs=years, mesh=mesh, **src)
    check(refused is None, f"mesh ensemble was refused: {refused}")
    for i, (a, b) in enumerate(zip(ens, got)):
        for k in a._fields:
            check(same(getattr(a, k), getattr(b, k)),
                  f"mesh ensemble: member {i}'s {k} differs from ensemble's")
    check(torch.equal(stats["lane_att"], ens_att),
          "mesh ensemble: attempts differ from ensemble's")
    print(f"mesh ensemble: {len(years)} members, 243,016 lanes, wall "
          f"{wall:.3f} s, launches {launches}; every member's rows and the "
          "attempts bitwise ensemble's")
    del got, ens
    run.ensemble = None

    driver = checkpoint.trace_rays_chunked
    n_chunks = -(-(cfg.nt - 1) // CHUNK_STEPS)
    kw = dict(src, chunk_steps=CHUNK_STEPS, verbose=False)
    with tempfile.TemporaryDirectory() as tmp:
        paths = dict(checkpoint_path=os.path.join(tmp, "ck.npz"),
                     stream_dir=os.path.join(tmp, "s"))
        _, first, wall1, _, _, stopped = traced(
            run, cfg, mesh_launches("dense_run", 2), driver=driver,
            stop=(checkpoint.ChunkBudgetReached,), bs=bs, mesh=mesh,
            max_chunks=2, **paths, **kw)
        check(isinstance(stopped, checkpoint.ChunkBudgetReached),
              f"mesh chunked: the budgeted run ended with {stopped!r}")
        _, _, _, _, _, bad = traced(
            run, cfg, {"dense_run": 0, "entry": 0}, driver=driver,
            stop=(ValueError,), bs=bs,
            mesh=Mesh((run.dev,) * (MESH_SHARDS + 1)), **paths, **kw)
        check(isinstance(bad, ValueError) and "mesh" in str(bad),
              f"mesh chunked: a resume under {MESH_SHARDS + 1} shards was "
              f"not refused ({bad!r})")
        resumed, rest, wall2, _, _, refused = traced(
            run, cfg, mesh_launches("dense_run", n_chunks - 2),
            driver=driver, bs=bs, mesh=mesh, **paths, **kw)
        check(refused is None, f"mesh chunked resume was refused: {refused}")
        for k in resumed._fields:
            check(same(getattr(resumed, k).to(run.dev),
                       getattr(run.main_traj, k)),
                  f"mesh chunked: resumed {k} differs from main_path's")
        del resumed
    print(f"mesh chunked: {n_chunks} chunks of {CHUNK_STEPS}, a 2-chunk "
          f"budget ({wall1:.3f} s, launches {first}), refused under "
          f"{MESH_SHARDS + 1} shards ({bad}), resumed ({wall2:.3f} s, "
          f"launches {rest}); rows bitwise main_path's")
    run.main_traj = run.main_att = None

    zwn = cfg.zwn_array()
    want = compute_wavenumber_maps(bs, zwn)
    got = compute_wavenumber_maps(bs, zwn, mesh=mesh)
    for k in want._fields:
        check(same(getattr(want, k).double(), getattr(got, k).double()),
              f"mesh wavenumber maps: {k} differs from the meshless maps")

    tmp = run.tmp
    u, v, lat, lon = climatology_background()
    wind = save_wind(os.path.join(tmp, "uv_mesh.npz"), u, v, lat, lon)
    short = dict(zwn=[float(z) for z in range(1, 8)], inputuv=wind,
                 ttotal=CLI_SHORT_DAYS * DAY, integrator="rk45",
                 bound_mode="dense", interval_batch=60, pin_limit=500,
                 pin_mwn=0.0, cal_dtype="float32")
    files = {}
    for name, flags in (("plain", []), ("mesh", ["--mesh"])):
        files[name] = {k: os.path.join(tmp, f"mesh_{name}_{k}.npz")
                       for k in ("rays", "wn")}
        rep, launches, wall = cli_run(
            run, tmp, f"mesh_{name}", dict(short, ncfile=files[name]["rays"]),
            flags + ["--wnmaps", files[name]["wn"]], "dense_run", 1)
        want_mesh = None if name == "plain" else {
            "rays": torch.cuda.device_count()}
        check(rep["mesh"] == want_mesh,
              f"cli {name}: report mesh {rep['mesh']}, not {want_mesh}")
        print_cli(f"mesh_{name}", rep, launches, wall, files[name])
    for k in ("rays", "wn"):
        with np.load(files["plain"][k]) as a, np.load(files["mesh"][k]) as b:
            check(sorted(a.files) == sorted(b.files)
                  and all(same_bits(a[x], b[x]) for x in a.files),
                  f"cli --mesh: the {k} file differs from the meshless "
                  "run's")
    print("mesh wavenumber maps: bitwise the meshless maps over "
          f"{MESH_SHARDS} shards; cli --mesh over "
          f"{torch.cuda.device_count()} card(s): report mesh "
          f"{rep['mesh']}, trajectory and map files bitwise the meshless "
          "run's")


def phase_time_spectral(run):
    """The spectral fit of the TV_DAYS + 1 daily frames
    (``fit_spectral_time``), blended at day 10 (``lerp_coeffs``), through
    the spectral kernel at the time-varying run's day-10 positions, against
    the plain sampler to the spectral phase's float32 bar."""
    torch = run.torch
    from rwrt_tpu_torch.ops import spectral_sample as spec

    sbg = spec.fit_spectral(run.tv_bs)
    check(tuple(sbg.coeffs.shape) == (TV_DAYS + 1, 145, 73, 18),
          f"time fit {tuple(sbg.coeffs.shape)}")
    day10 = spec.lerp_coeffs(sbg, 10.0)
    lon, lat = run.tv_day10
    before = spec.LAUNCHES
    k = spec.sample_spectral_cuda(day10, lon, lat)
    check(spec.LAUNCHES == before + 1, "the spectral kernel did not launch")
    p = spec.sample_spectral(day10, lon, lat)
    torch.cuda.synchronize()
    check(same_nan(k, p), "time_spectral: NaN rows differ")
    e = rel_err(p.T, k.T, dim=1)
    check(e <= 1e-5, f"time_spectral error {e} > 1e-05")
    ms = cuda_ms(lambda: spec.sample_spectral_cuda(day10, lon, lat), 20)
    print(f"time_spectral: {sbg.coeffs.shape[0]} frames fitted, blended at "
          f"day 10, R={lon.shape[0]} day-10 positions, max err / channel max "
          f"{e:.3e} (bar 1e-05), wrapper {ms:.4f} ms")

#: The cli phase: the production-size run's source matrix (80 x 60 = 4800
#: sources x zwn 1..7 = 100,800 rays), the short cases' days, and the
#: variables the JAX package's writers put in each file.
CLI_MATRIX = dict(sw_lon=0.0, dlon=4.5, nnx=80, sw_lat=-59.0, dlat=2.0,
                  nny=60)
CLI_SHORT_DAYS = 10
BS_FILE_KEYS = {"u", "v", "ux", "uy", "vx", "vy", "qx", "qy", "qxx", "qxy",
                "qyx", "qyy", "qxxx", "qxxy", "qxyy", "qyyy", "qyxx", "qyyx",
                "uxx", "uyy", "vxx", "vyy", "q", "betam", "KS", "lon", "lat"}
TRAJ_FILE_KEYS = {"zwn", "source_index", "time_index", "rlon", "rlat",
                  "rzwn", "rmwn", "ramp", "rug", "rvg"}
WN_FILE_KEYS = {"lon", "lat", "zwn", "mwn", "rootnum", "ug", "vg", "KS"}


def save_wind(path, u, v, lat, lon, **extra):
    """A wind file in the NetCDF convention: (..., lat, lon), degrees."""
    np.savez(path, u=np.swapaxes(u, -1, -2), v=np.swapaxes(v, -1, -2),
             lat=np.degrees(lat), lon=np.degrees(lon), **extra)
    return str(path)


def cli_run(run, tmp, name, cfg, flags, launches_of, n_launches):
    """``python -m rwrt_tpu_torch --config <name>.json --report ...`` in
    process (``rwrt_tpu_torch.__main__.main``, on the card), every launch
    counter set to 0 just before it and read just after. ``cfg`` is the
    JSON (inputuv, bsfile, ncfile and RunConfig keys). Returns (report,
    launches, wall s)."""
    import os

    torch = run.torch
    from rwrt_tpu_torch.__main__ import main as cli

    path = os.path.join(tmp, f"{name}.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    report = os.path.join(tmp, f"{name}_report.json")
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    check(cli(["--config", path, "--report", report] + flags) == 0,
          f"cli {name}: nonzero exit")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches(launches_of, n_launches, f"cli {name}")
    with open(report) as f:
        rep = json.load(f)
    check(rep["backend"] == "cuda" and rep["device_name"]
          == torch.cuda.get_device_name(0), f"cli {name}: report device")
    return rep, launches, wall


def file_equals(path, traj, what):
    """The trajectory file holds the in-process trajectory, bitwise after
    the writer's rad2deg, with the JAX writer's variables. Returns the
    seconds the writer's arrays took (the copy to the host, rad2deg)."""
    from rwrt_tpu_torch.io import ncio

    got = ncio.load_trajectories(path)
    check(set(got) == TRAJ_FILE_KEYS, f"{what}: file keys {sorted(got)}")
    t0 = time.perf_counter()
    want = ncio.trajectory_arrays(traj)
    seconds = time.perf_counter() - t0
    for k, a in want.items():
        check(same_bits(a, got[k]), f"{what}: {k} differs from the in-process "
              "run")
    return seconds


def same_bits(a, b):
    """Equal shapes, dtypes and NaN masks, and bitwise equal elsewhere."""
    return (a.shape == b.shape and a.dtype == b.dtype
            and np.array_equal(np.isnan(a), np.isnan(b))
            and np.array_equal(np.nan_to_num(a), np.nan_to_num(b)))


def on_cpu(bs):
    """A copy of a card BasicState on the CPU, the same values."""
    return bs._replace(**{k: getattr(bs, k).cpu() for k in (
        "fields", "lon", "lat", "betam", "ks", "q")})


#: The basic-state file against a CPU ``prepare`` of the same wind file in
#: float64: of each field's largest magnitude. The third derivatives of q
#: amplify a one-ulp difference of the card's and the host's sin/cos by
#: orders of magnitude (the tests' float64 bar, 1e-11, holds two CPU
#: packages to each other).
BS_CPU_BAR = 1e-9
#: The wavenumber maps against the CPU port on the same float32 state: of
#: each map's largest magnitude where the root counts agree, and the share
#: of (point, zwn) entries whose root count or NaN mask may differ (a
#: discriminant at float32 round-off of zero flips the count).
WN_CPU_BAR, WN_CPU_SHARE = 1e-4, 1e-4


def bs_file_equals(path, bs, cpu, what):
    """The basic-state file: the JAX writer's variables and shapes, each
    field bitwise the in-process card state's; with ``cpu`` (a float64
    state prepared on the CPU from the same file), each field within
    BS_CPU_BAR of it, NaN masks equal. Returns that largest error."""
    from rwrt_tpu_torch.io import ncio

    want = ncio.basic_state_fields(bs)
    worst = 0.0
    with np.load(path) as ds:
        check(set(ds.files) == BS_FILE_KEYS and ds["u"].shape == (144, 73)
              and ds["KS"].shape == (144, 73),
              f"{what}: basic-state file keys or shapes")
        for k, a in want.items():
            check(same_bits(a, ds[k]), f"{what}: basic-state {k} differs "
                  "from the in-process state")
    if cpu is not None:
        for k, r in ncio.basic_state_fields(cpu).items():
            a = want[k]
            check(np.array_equal(np.isnan(a), np.isnan(r)),
                  f"{what}: basic-state {k} NaN mask differs from the CPU's")
            worst = max(worst, float(np.nanmax(np.abs(a - r))
                                     / max(np.nanmax(np.abs(r)), 1e-300)))
        check(worst <= BS_CPU_BAR, f"{what}: basic state {worst:.3e} from "
              f"the CPU's > {BS_CPU_BAR}")
    return worst


def maps_equal(path, bs, zwn, what):
    """The wavenumber-map file: the JAX writer's variables and shapes,
    mwn / rootnum / ug / vg bitwise ``compute_wavenumber_maps`` in process
    on the same card state, KS the state's; and those maps against the CPU
    port's on a CPU copy of the state, within WN_CPU_BAR and WN_CPU_SHARE.
    Returns (entries whose count or mask differ, largest error per map)."""
    from rwrt_tpu_torch.diagnostics import compute_wavenumber_maps

    card = compute_wavenumber_maps(bs, zwn)
    host = {k: getattr(card, k).cpu().numpy()
            for k in ("mwn", "rootnum", "ug", "vg")}
    nz = len(zwn)
    with np.load(path) as ds:
        check(set(ds.files) == WN_FILE_KEYS
              and ds["mwn"].shape == (144, 73, nz, 3)
              and ds["rootnum"].shape == (144, 73, nz),
              f"{what}: wavenumber-map file keys or shapes")
        for k, a in host.items():
            check(same_bits(a, ds[k]), f"{what}: map {k} differs from "
                  "compute_wavenumber_maps in process")
        check(same_bits(bs.ks.cpu().numpy(), ds["KS"]),
              f"{what}: map KS differs from the state's")
    ref = compute_wavenumber_maps(on_cpu(bs), zwn)
    agree = host["rootnum"] == ref.rootnum.numpy()
    off = int(np.sum(~agree))
    errs = {}
    for k in ("mwn", "ug", "vg"):
        a, r = host[k], getattr(ref, k).numpy()
        both = agree[..., None] & ~np.isnan(a) & ~np.isnan(r)
        off += int(np.sum(agree[..., None] & (np.isnan(a) != np.isnan(r))))
        errs[k] = float(np.max(np.abs(a - r)[both], initial=0.0)
                        / np.nanmax(np.abs(r)))
    check(off <= WN_CPU_SHARE * agree.size
          and max(errs.values()) <= WN_CPU_BAR,
          f"{what}: maps against the CPU port's: {off} of {agree.size} "
          f"entries differ in count or mask, errors {errs}")
    return off, errs


def wind_state(run, path, cfg):
    """The library path's state from a wind file, as the CLI builds it, on
    the card."""
    from rwrt_tpu_torch.io import ncio

    u, v, lat, lon, times = ncio.load_wind(path, cfg.read_dtype,
                                           with_time=True)
    kw = dict(read_dtype=cfg.read_dtype, cal_dtype=cfg.cal_dtype,
              device=run.dev)
    if u.ndim == 3:
        return run.rt.prepare_time_varying(u, v, lat, lon, bg_t0=times[0],
                                           bg_dt=times[1] - times[0], **kw)
    return run.rt.prepare(u, v, lat, lon, **kw)


def cli_production_js(inputuv, tmp):
    """The production-size run's CLI JSON config (100,800 rays over the
    CLI_MATRIX sources, dense RK45, float32), its output files in
    ``tmp``."""
    import os

    return dict(CLI_MATRIX, inputuv=inputuv,
                bsfile=os.path.join(tmp, "bs_prod.npz"),
                ncfile=os.path.join(tmp, "ray_prod.npz"),
                zwn=[float(z) for z in range(1, 8)], tstep=2 * HOUR,
                ttotal=N_DAYS * DAY, integrator="rk45", bound_mode="dense",
                interval_batch=60, rtol=1e-6, atol=1e-6,
                min_step_factor=1e-3, cut_off=0.1, pin_limit=500,
                pin_mwn=0.0, cal_dtype="float32")


def json_config(rt, js):
    """The RunConfig of a CLI JSON config."""
    return rt.RunConfig(**{k: tuple(x) if isinstance(x, list) else x
                           for k, x in js.items()
                           if not k.startswith("_") and k not in (
                               "inputuv", "bsfile", "ncfile")})


def print_cli(name, rep, launches, wall, files):
    """The run's wall split (its --report), launches and file bytes."""
    import os

    split = rep["wall_s"]
    sizes = {k: os.path.getsize(p) for k, p in files.items()}
    trajs = rep.get("members") or [rep["trajectories"]]
    print(f"cli {name}: {len(trajs)} x {trajs[0]['n_rays']} rays x "
          f"{trajs[0]['nt']} rows, wall {wall:.3f} s; report wall split (s) "
          f"{json.dumps(split)}, io share {split['io'] / split['total']:.4f}"
          f"; launches {launches}; file bytes {json.dumps(sizes)}; "
          f"termination {json.dumps([t['termination'] for t in trajs])}")


def phase_cli(run):
    """The file-driven pipeline on the card: ``python -m rwrt_tpu_torch``
    in process over wind files of the climatology. The reference run
    (examples/reference_run.json: 6,615 rays, RK4, float64, 90 days) with
    --chunked; the production-size run (the 80 x 60 source matrix, 100,800
    rays, dense with pin, float32, 30 days) with --wnmaps and a basic-state
    file, in one launch; then CLI_SHORT_DAYS-day cases: a 3-D wind file
    (the time instance), a two-file ensemble (fused, one launch) and the
    reference run in root_order='fortran'. Each file against the same
    config through the library in process, bitwise; the basic-state and
    map files against the in-process state and maps, bitwise, and against
    the CPU port's; the reports' termination counts against ``analyze``;
    the launches per run or chunk. The files stay in ``run.tmp`` and the
    production-size run in ``run.prod`` for the phases after it."""
    import contextlib
    import os

    torch = run.torch
    rt = run.rt
    from rwrt_tpu_torch import tracer
    from rwrt_tpu_torch.diagnostics import termination
    from rwrt_tpu_torch.io import ncio

    with open(REPO / "examples" / "reference_run.json") as f:
        reference = json.load(f)

    def state(path, cfg):
        return wind_state(run, path, cfg)

    def config(js):
        return json_config(rt, js)

    def counts_equal(rep, traj, what):
        """Returns the seconds ``analyze`` took."""
        t0 = time.perf_counter()
        want = termination.analyze(traj).counts
        check(rep == want, f"{what}: report termination {rep} != {want}")
        return time.perf_counter() - t0

    with contextlib.nullcontext(run.tmp) as tmp:
        u, v, lat, lon = climatology_background()
        static = save_wind(os.path.join(tmp, "uv.npz"), u, v, lat, lon)
        uf, vf, _, _ = climatology_frames(TV_DAYS + 1)
        frames = save_wind(os.path.join(tmp, "uv_daily.npz"), uf, vf, lat,
                           lon, time=np.arange(TV_DAYS + 1) * DAY)
        members = []
        for i, (sc, ph) in enumerate(zip(MEMBER_SCALES[:2],
                                         MEMBER_PHASES[:2])):
            um, vm, _, _ = climatology_frames(1, sc, ph)
            members.append(save_wind(os.path.join(tmp, f"uv_year{i}.npz"),
                                     um[0], vm[0], lat, lon))

        # The reference run, chunked: one RK4 launch per chunk.
        js = dict(reference, inputuv=static,
                  bsfile=os.path.join(tmp, "bs_out.npz"),
                  ncfile=os.path.join(tmp, "ray_out.npz"))
        cfg = config(js)
        n_chunks = -(-(cfg.nt - 1) // 64)
        rep, launches, wall = cli_run(run, tmp, "reference", js,
                                      ["--chunked"], "rk4_run", n_chunks)
        traj = rt.trace_rays_chunked(state(static, cfg), cfg, verbose=False)
        file_equals(js["ncfile"], traj, "cli reference")
        counts_equal(rep["trajectories"]["termination"], traj,
                     "cli reference")
        u32, v32, lat32, lon32 = ncio.load_wind(static, cfg.read_dtype)
        bs_err = bs_file_equals(
            js["bsfile"], state(static, cfg), rt.prepare(
                u32, v32, lat32, lon32, read_dtype=cfg.read_dtype,
                cal_dtype=cfg.cal_dtype, device="cpu"), "cli reference")
        print_cli("reference", rep, launches, wall,
                  {"ncfile": js["ncfile"], "bsfile": js["bsfile"]})
        print(f"  cli reference: basic-state file bitwise the in-process "
              f"state's; {bs_err:.3e} of each field's max from a CPU "
              f"prepare (bar {BS_CPU_BAR})")
        del traj

        # The production-size run: one dense launch, the wavenumber maps.
        js = cli_production_js(static, tmp)
        wn = os.path.join(tmp, "wn_prod.npz")
        cfg = config(js)
        rep, launches, wall = cli_run(run, tmp, "production", js,
                                      ["--wnmaps", wn], "dense_run", 1)
        check(rep["trajectories"]["n_rays"] == 100_800,
              "cli production: not 100,800 rays")
        bs = state(static, cfg)
        traj = rt.trace_rays(bs, cfg)
        arrays_s = file_equals(js["ncfile"], traj, "cli production")
        analyze_s = counts_equal(rep["trajectories"]["termination"], traj,
                                 "cli production")
        bs_file_equals(js["bsfile"], bs, None, "cli production")
        off, errs = maps_equal(wn, bs, cfg.zwn_array(), "cli production")
        print_cli("production", rep, launches, wall,
                  {"ncfile": js["ncfile"], "bsfile": js["bsfile"],
                   "wnmaps": wn})
        io = rep["wall_s"]["io"]
        print(f"  cli production io parts, timed on the in-process run: the "
              f"writer's arrays (copy to the host, rad2deg) {arrays_s:.3f} "
              f"s; the rest of io (the files' np.savez_compressed, the "
              f"maps) {io - arrays_s:.3f} s of {io:.3f}; analyze "
              f"{analyze_s:.3f} s, outside the report's split")
        print(f"  cli production: basic-state and map files bitwise the "
              f"in-process state's and maps; maps against the CPU port's: "
              f"{off} (point, zwn) entries differ in count or mask, errors "
              f"of each map's max {json.dumps(errs)} (bar {WN_CPU_BAR})")
        run.prod = dict(traj=traj, bs=bs, cfg=cfg, ncfile=js["ncfile"],
                        wind=static, js=js)
        del traj, bs

        # Short cases over the README's sources.
        short = dict(zwn=[float(z) for z in range(1, 8)],
                     ttotal=CLI_SHORT_DAYS * DAY, integrator="rk45",
                     bound_mode="dense", interval_batch=60,
                     pin_limit=500, pin_mwn=0.0, cal_dtype="float32")
        js = dict(short, inputuv=frames,
                  ncfile=os.path.join(tmp, "ray_daily.npz"))
        cfg = config(js)
        rep, launches, wall = cli_run(run, tmp, "daily_frames", js, [],
                                      "dense_run", 1)
        check(rep["grid"]["time_varying"], "cli daily_frames: static grid")
        traj = rt.trace_rays(state(frames, cfg), cfg)
        file_equals(js["ncfile"], traj, "cli daily_frames")
        print_cli("daily_frames", rep, launches, wall,
                  {"ncfile": js["ncfile"]})

        js = dict(short, inputuv=members,
                  ncfile=os.path.join(tmp, "ray_{member}.npz"))
        cfg = config(js)
        rep, launches, wall = cli_run(run, tmp, "ensemble", js, [],
                                      "dense_run", 1)
        trajs = rt.trace_rays_ensemble([state(p, cfg) for p in members],
                                       cfg)
        for i, (traj, r) in enumerate(zip(trajs, rep["members"])):
            file_equals(js["ncfile"].format(member=i), traj,
                        f"cli ensemble member {i}")
            counts_equal(r["termination"], traj, f"cli ensemble member {i}")
        print_cli("ensemble", rep, launches, wall,
                  {"ncfile_0": js["ncfile"].format(member=0)})

        js = dict(reference, inputuv=static, root_order="fortran",
                  ttotal=CLI_SHORT_DAYS * DAY, bsfile=None,
                  ncfile=os.path.join(tmp, "ray_fortran.npz"))
        cfg = config(js)
        rep, launches, wall = cli_run(run, tmp, "fortran", js, [],
                                      "rk4_run", 1)
        bs = state(static, cfg)
        traj = rt.trace_rays(bs, cfg)
        file_equals(js["ncfile"], traj, "cli fortran")
        # The seeds: per (source, zwn) the canonical roots, reordered.
        bg = tracer.make_background(bs, cfg.freq)
        src = [torch.as_tensor(x, dtype=torch.float64, device=run.dev)
               for x in (*tracer.source_matrix(
                   cfg.sw_lon, cfg.sw_lat, cfg.dlon, cfg.dlat, cfg.nnx,
                   cfg.nny), cfg.zwn_array())]
        fortran = traj.ky[0].cpu().numpy()
        canon = tracer.initialize(bg, *src)[0][3].cpu().numpy().reshape(
            fortran.shape)
        a, b = (np.sort(np.where(np.isnan(x), np.inf, x), axis=0)
                for x in (fortran, canon))
        fin = np.isfinite(b)
        check(np.array_equal(np.isfinite(a), fin)
              and np.all(np.abs(a[fin] - b[fin])
                         <= 1e-6 * np.maximum(1.0, np.abs(b[fin]))),
              "cli fortran: sorted roots differ from the canonical ones")
        moved = int(np.sum(np.any(np.nan_to_num(fortran)
                                  != np.nan_to_num(canon), axis=0)))
        cpu = tracer.initialize(
            tracer.make_background(on_cpu(bs), cfg.freq),
            *(x.cpu() for x in src), "fortran")[0][3].numpy()
        check(np.array_equal(np.isnan(cpu), np.isnan(fortran.reshape(-1)))
              and np.allclose(cpu, fortran.reshape(-1), rtol=1e-9,
                              atol=1e-12, equal_nan=True),
              "cli fortran: the slot layout differs from the CPU port's")
        print_cli("fortran", rep, launches, wall, {"ncfile": js["ncfile"]})
        print(f"  cli fortran: {moved} of {fin.shape[1] * fin.shape[2]} "
              "(source, zwn) seeds in another slot order than canonical; "
              "sorted roots within 1e-6 of canonical; slots as the CPU "
              "port's")


#: The flux phases: the Fun2 target box (the North Pacific), Fun1's
#: abnormal-wavenumber cap, the chunked path's time block; flops counted
#: from csrc/flux.cu: a point the binning kernel reads (the unwrap, 8) and
#: one it bins (the bins 6, the amp_cg weights 2, four adds), and a point
#: of the region pass (3).
FLUX_BOX = ((150.0, 240.0), (20.0, 60.0))
FLUX_MWN_MAX = 100.0
FLUX_BLOCK = 64
UNWRAP_FLOPS = 8
BIN_FLOPS = 6 + 2 + 4
REGION_FLOPS = 3
#: The flux kernel's maps against the plain version's, float32, as a
#: fraction of each map's largest magnitude: the atomics add a cell's
#: points in an order that changes from run to run (count, a sum of ones,
#: is bitwise).
FLUX_BAR = 1e-4
#: The chunked maps' count against the one-shot's, as a share of the
#: binned points: each block's unwrap restarts its running sum from the
#: carry, so float32 rounding may move a point that sits on a cell edge.
#: On the production-size trajectories 6 of the 7,825,596 binned points
#: move at 64-row blocks (7.7e-7); the bar leaves that reading room.
CHUNK_COUNT_SHARE = 2e-6
#: The binning's launches, by kernel name, timed apart under
#: torch.profiler.
FLUX_PARTS = ("compact_kernel", "unwrap_kernel", "points_kernel",
              "maps_kernel")


def launch_parts(fn, names, reps=50):
    """Device microseconds a launch of each kernel whose name holds one of
    ``names`` takes: the mean over the launches torch.profiler recorded in
    ``reps`` calls of ``fn``; {} where it recorded none. The mean is over
    the launches recorded, not the calls: on the H100 machine the profiler
    (torch 2.11) drops some of a session's records, none early in a
    process and a dozen or more once it has run for minutes, so a short
    session may record none."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    parts = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", 0) or getattr(
            e, "cuda_time_total", 0)
        for n in names:
            if n in e.key and us and e.count:
                parts[n] = round(us / e.count, 2)
    return parts


def flux_kw():
    return dict(lon_range=FLUX_BOX[0], lat_range=FLUX_BOX[1],
                mwn_max=FLUX_MWN_MAX)


def maps_err(got, want):
    """(max |got - want| over the four maps, the largest of it over each
    map's max |want|); count must be bitwise."""
    abs_err = rel = 0.0
    for a, b in zip(got, want):
        a = a.to(b.dtype)
        d = float(abs(a - b).nan_to_num(nan=0.0).max())
        abs_err = max(abs_err, d)
        rel = max(rel, d / max(float(b.abs().nan_to_num(nan=0.0).max()),
                               1e-300))
    return abs_err, rel


def region_alone_ms(run, rows, want, reps):
    """The region kernel alone: ``reps`` launches of ``rwrt_flux_region``
    over the (nt, R) rows (lon, lat, amp) as ``flux._region_cuda`` makes
    them, each into a zeroed keep of its own (a launch ORs into its keep:
    one reused would hold the last launch's hits and skip their rays),
    between CUDA events, without the wrapper's copy of keep and its
    checks. Each keep must come out equal to ``want``. Returns ms a
    launch."""
    torch = run.torch
    from rwrt_tpu_torch import kernels
    from rwrt_tpu_torch.diagnostics import flux

    lon, lat, amp = rows
    nt, r = lon.shape
    box = flux._box(*FLUX_BOX, lon.dtype)
    keeps = [torch.zeros(r, dtype=torch.bool, device=run.dev)
             for _ in range(reps + 1)]

    def launch(keep):
        kernels.launch("rwrt_flux_region", lon.dtype, lon, lat, amp,
                       lon.stride(0), lat.stride(0), amp.stride(0), nt, r,
                       *box, keep, kernels.stream(lon.device))

    launch(keeps[-1])
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for keep in keeps[:reps]:
        launch(keep)
    end.record()
    torch.cuda.synchronize()
    check(all(torch.equal(k, want) for k in keeps),
          "flux region kernel alone: a keep differs from the wrapper's")
    return start.elapsed_time(end) / reps


def phase_flux(run):
    """The flux kernel on the cli phase's production-size trajectories
    (100,800 rays x 361 rows, float32, in process on the card) with the
    Fun2 box and the mwn cap: the region pass bitwise against its plain
    version; the binning kernel against ``_accumulate_plain`` (count
    bitwise, the other maps within FLUX_BAR); kernel, wrapper
    (``wave_ray_flux``: region pass, binning, centers), plain and
    ``index_add_`` times and the bounds; ``wave_ray_flux_chunked`` over a
    host copy in FLUX_BLOCK-row blocks and in one block against the
    one-shot maps."""
    torch = run.torch
    from rwrt_tpu_torch.diagnostics import flux
    from rwrt_tpu_torch.tracer import RayTrajectories

    traj = run.prod["traj"]
    kw = flux_kw()
    names = ("lon", "lat", "amp", "ug", "vg", "ky")
    rows = [flux._rows(getattr(traj, k)) for k in names]
    nt, r = rows[0].shape
    zero = torch.zeros(r, dtype=torch.bool, device=run.dev)
    keep = flux._region_cuda(*rows[:3], zero, *FLUX_BOX)
    keep_p = flux._region_plain(*rows[:3], zero, *FLUX_BOX)
    torch.cuda.synchronize()
    check(torch.equal(keep, keep_p), "flux region pass differs from plain")
    # A keep carried in, as the chunked path's blocks carry it: the kept
    # rays of the first FLUX_BLOCK rows into the rest.
    first = flux._region_cuda(*(x[:FLUX_BLOCK] for x in rows[:3]), zero,
                              *FLUX_BOX)
    rest = flux._region_cuda(*(x[FLUX_BLOCK:] for x in rows[:3]), first,
                             *FLUX_BOX)
    check(torch.equal(first, flux._region_plain(
        *(x[:FLUX_BLOCK] for x in rows[:3]), zero, *FLUX_BOX))
        and torch.equal(rest, flux._region_plain(
            *(x[FLUX_BLOCK:] for x in rows[:3]), first, *FLUX_BOX))
        and torch.equal(rest, keep),
        "flux region pass with a carried keep differs from plain")
    th = flux.Thresholds(mwn_max=FLUX_MWN_MAX)
    args = (*rows, keep, None, 360, 90, th, "amp_cg")
    kern, carry = flux._accumulate_cuda(*args)
    plain, pcarry = flux._accumulate_plain(*args)
    torch.cuda.synchronize()
    check(torch.equal(kern[3], plain[3]), "flux count differs from plain")
    check(all(same(a, b) for a, b in zip(carry, pcarry)),
          "flux carry differs from plain")
    abs_err, rel = maps_err(kern, plain)
    check(rel <= FLUX_BAR, f"flux maps {rel:.3e} of their max from plain "
          f"> {FLUX_BAR}")
    wrf = flux.wave_ray_flux(traj, **kw)
    check(torch.equal(wrf.count, kern[3]), "wave_ray_flux count differs "
          "from the kernel's")

    ms = cuda_ms(lambda: flux._accumulate_cuda(*args), 10)
    parts = launch_parts(lambda: flux._accumulate_cuda(*args), FLUX_PARTS)
    region_kernel_ms = region_alone_ms(run, rows[:3], keep, 10)
    wrapper_ms = cuda_ms(lambda: flux.wave_ray_flux(traj, **kw), 10)
    plain_ms = cuda_ms(lambda: flux._accumulate_plain(*args), 2)
    region_ms = cuda_ms(lambda: flux._region_cuda(*rows[:3], zero,
                                                  *FLUX_BOX), 10)
    region_plain_ms = cuda_ms(lambda: flux._region_plain(
        *rows[:3], zero, *FLUX_BOX), 3)
    # The library yardstick: one index_add_ of the four maps' values over
    # the binned points' precomputed flat indices (the scatter only).
    lon_u = flux._unwrap_lon(rows[0])
    valid = flux._valid(*rows, th) & keep[None]
    inv_dlon, inv_dlat = flux._bin_scales(360, 90, rows[0].dtype)
    flat = (flux._bin_index((flux.true_div(lon_u, flux.deg2rad) + 360.0)
                            * inv_dlon, 360) * 90
            + flux._bin_index((flux.true_div(rows[1], flux.deg2rad) + 90.0)
                              * inv_dlat, 90))[valid]
    amp, ug, vg = rows[2], rows[3], rows[4]
    vals = torch.stack([(amp * ug)[valid], (amp * vg)[valid],
                        amp.abs()[valid], torch.ones_like(amp)[valid]], 1)
    maps = torch.zeros((360 * 90, 4), dtype=amp.dtype, device=run.dev)
    maps.index_add_(0, flat, vals)
    check(torch.equal(maps[:, 3].reshape(360, 90), kern[3]),
          "index_add_ yardstick bins differ from the kernel's")
    library_ms = cuda_ms(lambda: maps.index_add_(0, flat, vals), 10)

    # Bounds: what this run's data needs. The binning kernel reads every
    # ray's keep byte, lon, lat and amp at each point of a kept ray, ug, vg
    # and ky at those that pass the finite test, and writes the maps and
    # the carry once; a dropped ray reads nothing more. The region pass
    # reads every ray's keep byte and lon, lat and amp at the rows up to the
    # first one in the box (every row of a ray that never enters), and
    # writes the keep byte of a ray that enters.
    kept = int(keep.sum())
    fin = int((torch.isfinite(rows[0]) & torch.isfinite(rows[1])
               & torch.isfinite(rows[2]) & keep[None]).sum())
    binned = int(valid.sum())
    in_box = flux._in_box_arrays(*rows[:3], *FLUX_BOX)
    last = torch.where(in_box.any(0), in_box.to(torch.int8).argmax(0),
                       nt - 1)
    region_rows = int((last + 1).sum())
    # What the kernel reads: a ray's rows to the end of the 64-row tile of
    # its first point in the box.
    tile_rows = int(torch.clamp((last // 64 + 1) * 64, max=nt).sum())
    del in_box, last
    esz = rows[0].element_size()
    b = bound((3 * nt * kept + 3 * fin) * esz + 4 * 360 * 90 * esz
              + 2 * r * esz + r, nt * kept * UNWRAP_FLOPS
              + binned * BIN_FLOPS, "float32")
    # The same reads at the memory's 32-byte sectors: a kept ray's value
    # brings its sector, shared with the rays beside it in the row.
    sectors = int(torch.unique(torch.nonzero(keep)[:, 0]
                               // (32 // esz)).numel())
    sector_bytes = 6 * nt * sectors * 32
    rb = bound(3 * region_rows * esz + r + kept,
               region_rows * REGION_FLOPS, "float32")
    every = 5 * nt * r * esz
    print(f"flux: the binning's launches (torch.profiler, device us): "
          + json.dumps(parts) + f"; the kept rays' six fields read at "
          f"32-byte sectors ({sectors} sectors a row): "
          f"{sector_bytes / 1e6:.1f} MB, "
          f"{sector_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms")
    print(f"flux: {r} rays x {nt} rows = {nt * r} points, {kept} rays "
          f"enter the box {FLUX_BOX}, {binned} points binned; binning "
          f"kernel {ms:.4f} ms, wrapper (region pass + binning) "
          f"{wrapper_ms:.4f} ms, plain {plain_ms:.3f} ms, index_add_ of the "
          f"four maps {library_ms:.4f} ms, bound {b['bound_ms']:.4f} ms "
          f"({b['bound_by']}; every point's five fields: {every / 1e6:.1f} "
          f"MB, {every / HBM_BYTES_PER_S * 1e3:.4f} ms); count bitwise, "
          f"other maps {rel:.3e} of their max from plain (bar {FLUX_BAR}), "
          f"carry bitwise")
    print(f"flux region pass: {region_rows} of the {nt * r} points needed "
          f"(each ray's rows up to its first in the box), {tile_rows} read "
          f"(to the end of that row's 64-row tile); wrapper "
          f"{region_ms:.4f} ms, the kernel alone (CUDA events) "
          f"{region_kernel_ms:.4f} ms, plain {region_plain_ms:.3f} ms, bound "
          f"{rb['bound_ms']:.4f} ms ({rb['bound_by']}; the tiles' reads "
          f"{3 * tile_rows * esz / HBM_BYTES_PER_S * 1e3:.4f} ms), bitwise, "
          f"and with a keep carried from the first {FLUX_BLOCK} rows")
    run.kernels["flux"] = dict(max_abs_err=abs_err, ms=ms, plain_ms=plain_ms,
                               library_ms=library_ms, **b)
    run.kernels["flux_region"] = dict(max_abs_err=0.0, ms=region_ms,
                                      kernel_ms=region_kernel_ms,
                                      plain_ms=region_plain_ms,
                                      library_ms=None, **rb)
    del lon_u, valid, flat, vals, maps

    # The chunked path over a host copy: one block copied at a time.
    host = RayTrajectories(*(x.cpu() for x in traj))
    for tb in (FLUX_BLOCK, nt):
        (ch, wall) = wall_s(lambda: flux.wave_ray_flux_chunked(
            host, time_block=tb, device=run.dev, **kw))
        one = [x.to(torch.float64) for x in wrf[2:]]
        moved = float((ch.count - one[3]).abs().sum()) / 2
        share = moved / max(float(one[3].sum()), 1.0)
        err = maps_err(ch[2:], one)[1]
        print(f"flux chunked, time_block {tb}: {-(-nt // tb)} blocks, wall "
              f"{wall:.3f} s (host copy to the card included); {moved:.0f} "
              f"points in another cell than one-shot ({share:.2e} of the "
              f"binned, bar {CHUNK_COUNT_SHARE}), maps {err:.3e} of their "
              "max")
        check(share <= CHUNK_COUNT_SHARE and err <= FLUX_BAR,
              f"flux chunked {tb}: {share} of the points moved, maps "
              f"{err:.3e} of their max from one-shot")
        if tb >= nt:
            check(moved == 0, "flux chunked in one block differs from "
                  "one-shot")
    del host


def phase_wrf_cli(run):
    """``python -m rwrt_tpu_torch.diagnostics.wrf_cli`` in process on the
    cli phase's production-size trajectory file (no new trace), with the
    Fun2 box and the mwn cap: every counter reset just before it and read
    just after (one binning launch, one region pass, no other kernel), its
    wall split into load, bin, region statistics and write (the module's
    functions timed where they run); the file's maps against
    ``wave_ray_flux`` in process on the file's trajectories (count
    bitwise, the other maps within FLUX_BAR), its n_passing and first
    entries against the region mask."""
    import os

    torch = run.torch
    from rwrt_tpu_torch.diagnostics import flux, wrf_cli
    from rwrt_tpu_torch.io import ncio

    path = run.prod["ncfile"]
    out = os.path.join(run.tmp, "wrf_prod.npz")
    split = {}

    def timed(name, fn):
        def wrapped(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn(*a, **k)
            torch.cuda.synchronize()
            split[name] = split.get(name, 0.0) + time.perf_counter() - t0
            return res
        return wrapped

    saved = (wrf_cli.load_ray_output, wrf_cli.write_flux,
             flux.wave_ray_flux, flux.region_statistics)
    wrf_cli.load_ray_output = timed("load", saved[0])
    wrf_cli.write_flux = timed("write", saved[1])
    flux.wave_ray_flux = timed("bin", saved[2])
    flux.region_statistics = timed("region_statistics", saved[3])
    argv = ["--traj", path, "--out", out, "--lon-range",
            *map(str, FLUX_BOX[0]), "--lat-range", *map(str, FLUX_BOX[1]),
            "--mwn-max", str(FLUX_MWN_MAX)]
    try:
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        check(wrf_cli.main(argv) == 0, "wrf_cli: nonzero exit")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches({"flux": 1, "flux_region": 1}, None,
                                 "wrf_cli")
    finally:
        (wrf_cli.load_ray_output, wrf_cli.write_flux, flux.wave_ray_flux,
         flux.region_statistics) = saved
    run.launches["flux"] = launches["flux"]
    run.launches["flux_region"] = launches["flux_region"]

    tr = wrf_cli.trajectories_from_files(
        [ncio.trajectory_arrays(run.prod["traj"])], run.dev)
    ref = flux.wave_ray_flux(tr, **flux_kw())
    mask = flux.region_mask(tr, *FLUX_BOX).cpu().numpy()
    with np.load(out) as ds:
        got = {k: ds[k] for k in ds.files}
    check(np.array_equal(got["count"], ref.count.cpu().numpy()),
          "wrf_cli: the file's count differs from wave_ray_flux in process")
    err = maps_err([torch.as_tensor(got[k], device=run.dev)
                    for k in ("flux_u", "flux_v", "amp_sum")], ref[2:5])[1]
    check(err <= FLUX_BAR, f"wrf_cli: maps {err:.3e} of their max from "
          "wave_ray_flux in process")
    check(int(got["n_passing"]) == int(mask.sum())
          and np.array_equal(got["first_entry_step"] >= 0, mask),
          "wrf_cli: the region aggregates disagree with the region mask")
    print(f"wrf_cli: {path.rsplit('/', 1)[-1]} "
          f"({os.path.getsize(path) / 2 ** 20:.1f} MiB), wall {wall:.3f} s, "
          f"split (s) {json.dumps({k: round(v, 4) for k, v in split.items()})}"
          f", rest {wall - sum(split.values()):.3f} s; launches flux "
          f"{launches['flux']} flux_region {launches['flux_region']}; "
          f"n_passing {int(got['n_passing'])}; the file's count bitwise and "
          f"maps {err:.3e} of their max from wave_ray_flux in process")
    del tr, ref


#: The classify phase's plain comparison of the RK45 re-run: the interval
#: kernel and the plain loop over ``ray._rhs_core`` both cut at this many
#: trips a lane, on every dead lane. The report's re-run takes the JAX
#: package's 10,000, and float32 lanes of the production-size run stall
#: there: the plain loop, ~20 ms a trip on the card, would take minutes
#: over them. A lane's re-run is its own (the per-lane cap,
#: tests/test_torch_interval.py), so the report's re-run equals the cut one
#: on every lane that finishes within the cut.
CLASSIFY_PLAIN_ITERS = 500
#: The interval kernel's timed launches (CUDA events).
INTERVAL_REPS = 3


def plain_rhs(bg, y, t):
    """The plain RHS in ``cause_labels``' form (the plain re-run)."""
    from rwrt_tpu_torch.models import ray

    return ray._rhs_core(bg, y, t, False)[:2]


def phase_classify(run):
    """``--report-exact`` through the CLI in process (no output files) on
    the reference run (RK4), on it over the cli phase's daily frames (the
    RHS's time instance) and on the production-size run (dense RK45),
    every counter reset just before and read just after (the run's one
    whole-run launch; RK45: one entry-stage launch for the run and one for
    the re-run, no RHS launch, one interval-kernel launch; RK4: 4 RHS
    launches, the kernels line's rhs and rhs_time): the report's causes
    exact, every ray in one bucket, and equal to the counts of the labels
    ``classify`` gave inside the run (``termination.cause_labels``, kept
    and timed with its ``stats``: the re-run's entry, state and each lane's
    trips); its rays the dead rays of the same config's trajectory in
    process. Then, on that trajectory, the labels and candidate states
    through the kernels against the plain RHS's run on the card, bitwise on
    every lane (the RK45 re-run cut at CLASSIFY_PLAIN_ITERS trips in both),
    and the report's own labels and states against them on every lane the
    report's re-run finished within the cut. The interval kernel timed at
    the report's entry and cap and on its longest lane alone (the chain
    floor); and at the cut beside the plain loop alone on the same entry
    and cut (``rk45._integrate_interval_plain``, bitwise), and its bound
    for that work."""
    torch = run.torch
    rt = run.rt
    from rwrt_tpu_torch import kernels, tracer
    from rwrt_tpu_torch.convert import host
    from rwrt_tpu_torch.diagnostics import termination
    from rwrt_tpu_torch.models import ray
    from rwrt_tpu_torch.solvers import rk45

    with open(REPO / "examples" / "reference_run.json") as f:
        reference = json.load(f)
    cases = (("reference", dict(reference, inputuv=run.prod["wind"]),
              "rk4_run", None),
             ("daily_frames", dict(reference, inputuv=str(
                 Path(run.tmp) / "uv_daily.npz")), "rk4_run", None),
             ("production", dict(run.prod["js"]), "dense_run", run.prod))
    dead = 0
    labels_of = termination.cause_labels
    for name, js, unit, prod in cases:
        js.update(bsfile=None, ncfile=None)
        cfg = json_config(rt, js)
        adaptive = cfg.integrator != "rk4"
        # The CLI's own re-run: its labels, seconds, launches and stats.
        seen = []

        def kept(*a, **k):
            before = (ray.LAUNCHES, rk45.INTERVAL_LAUNCHES,
                      tracer.ENTRY_LAUNCHES)
            st = {}
            res, secs = wall_s(lambda: labels_of(*a, stats=st, **k))
            seen.append((res, secs, ray.LAUNCHES - before[0],
                         rk45.INTERVAL_LAUNCHES - before[1],
                         tracer.ENTRY_LAUNCHES - before[2], st))
            return res

        termination.cause_labels = kept
        try:
            # An adaptive run's entry stage, and its re-run's.
            rep, launches, wall = cli_run(
                run, run.tmp, f"{name}_exact", js, ["--report-exact"],
                {unit: 1, "interval": int(adaptive),
                 "entry": 2 * int(adaptive)}, None)
        finally:
            termination.cause_labels = labels_of
        summary = rep["trajectories"]
        check(summary["termination_causes"] == "exact"
              and sum(summary["termination"].values())
              == summary["n_rays"], f"classify {name}: report")
        if prod is None:
            bs = wind_state(run, js["inputuv"], cfg)
            traj = rt.trace_rays(bs, cfg)
        else:
            bs, traj = prod["bs"], prod["traj"]
        base = termination.analyze(traj)
        check(len(seen) == 1, f"classify {name}: {len(seen)} re-runs")
        (labels, k_s, rhs_launches, iv_launches, entry_launches, st), = seen
        n = labels.size
        check(n == int(((base.death_step >= 1) & (
            base.death_step < cfg.nt)).sum()), f"classify {name}: the "
            "re-run's rays are not the in-process trajectory's dead rays")
        check(n > 0, f"classify {name}: no dead ray")
        check((iv_launches, rhs_launches, entry_launches)
              == ((0, 4, 0) if not adaptive else (1, 0, 1)),
              f"classify {name}: {rhs_launches} RHS, {entry_launches} entry "
              f"and {iv_launches} interval launches in the re-run")
        if not adaptive:
            # The RHS kernel's path: the RK4 re-run's four stages (the
            # time instance's over the daily frames).
            run.launches["rhs" if name == "reference"
                         else "rhs_time"] = launches["rhs"]
        want = {"no_root": base.counts["no_root"],
                "survived": base.counts["survived"],
                **{c: int((labels == i).sum())
                   for i, c in enumerate(termination.CAUSES)}}
        check(summary["termination"] == want, f"classify {name}: report "
              f"{summary['termination']} != its labels' counts {want}")
        dead += n
        cut = dict(max_iters=CLASSIFY_PLAIN_ITERS) if adaptive else {}
        ks, ps = {}, {}
        kern, kc_s = wall_s(lambda: termination.cause_labels(
            traj, bs, cfg, base.death_step, stats=ks, **cut))
        plain, p_s = wall_s(lambda: termination.cause_labels(
            traj, bs, cfg, base.death_step, rhs=plain_rhs, stats=ps, **cut))
        check(np.array_equal(kern, plain) and same(ks["state"], ps["state"]),
              f"classify {name}: labels or states through the kernels "
              "differ from the plain RHS's")
        head = (f"classify {name}: {summary['n_rays']} rays, {n} dead "
                f"re-run ({cfg.integrator}); report "
                f"{json.dumps(summary['termination'])}; --report-exact wall "
                f"{wall:.3f} s (split {json.dumps(rep['wall_s'])}); the "
                f"report's re-run {k_s:.4f} s ({rhs_launches} RHS launches, "
                f"{entry_launches} entry launch, {iv_launches} interval "
                "launch)")
        if not adaptive:
            check(np.array_equal(labels, plain) and same(
                st["state"], ps["state"]), f"classify {name}: the report's "
                "labels differ from the plain RHS's")
            print(f"{head}; kernels {kc_s:.3f} s, plain RHS {p_s:.3f} s, "
                  "labels and states bitwise per lane, the report's too")
            continue
        check(torch.equal(ks["lane_att"], ps["lane_att"]),
              f"classify {name}: trips differ from the plain loop's")
        trips = host(st["lane_att"]).astype(np.int64)
        short = trips <= CLASSIFY_PLAIN_ITERS
        sel = torch.as_tensor(np.flatnonzero(short), device=run.dev)
        check(np.array_equal(labels[short], plain[short])
              and same(st["state"][:, sel], ps["state"][:, sel]),
              f"classify {name}: the report's labels or states differ from "
              "the plain ones on lanes finished within the cut")

        # The interval kernel at the report's entry.
        y, t0, h0, bound = st["entry"]
        dt = y.dtype
        bg = tracer.make_background(bs, cfg.freq)
        tol = (rk45.validate_tol(cfg.rtol, dt), rk45.as_scalar(cfg.atol, dt),
               rk45.as_scalar(min(cfg.min_step_factor * cfg.tstep,
                                  cfg.tstep * 1e-3), dt))
        inst = rk45.interval_instance(n, dt)

        def interval(lanes=None, cap=10_000):
            e = [x if lanes is None else x[..., lanes].contiguous()
                 for x in (y, t0, h0, bound)]
            return rk45._integrate_interval_cuda(bg, *e, *tol,
                                                 max_iters=cap,
                                                 instance=inst)

        full = interval()
        check(same(full[0], st["state"]) and torch.equal(full[5],
                                                         st["lane_att"]),
              f"classify {name}: the interval kernel differs from the "
              "report's re-run")
        lane = int(np.argmax(trips))
        lone = interval([lane])
        check(same(lone[0][:, 0], full[0][:, lane])
              and int(lone[5][0]) == trips[lane],
              f"classify {name}: the longest lane alone differs")
        report_ms = cuda_ms(interval, INTERVAL_REPS)
        by_inst = {}
        for other in kernels.INSTANCES:
            got = rk45._integrate_interval_cuda(
                bg, y, t0, h0, bound, *tol, max_iters=10_000,
                instance=other)
            check(same(got[0], full[0]) and torch.equal(got[5], full[5]),
                  f"classify {name}: instance {other} differs")
            by_inst[other] = cuda_ms(lambda: rk45._integrate_interval_cuda(
                bg, y, t0, h0, bound, *tol, max_iters=10_000,
                instance=other), INTERVAL_REPS)
        floor_ms = cuda_ms(lambda: interval([lane]), INTERVAL_REPS)
        # The kernel beside the plain loop alone on the same work: the
        # report's entry, each lane cut at CLASSIFY_PLAIN_ITERS trips.
        cut_out = interval(cap=CLASSIFY_PLAIN_ITERS)
        loop, loop_s = wall_s(lambda: rk45._integrate_interval_plain(
            bg, y, t0, h0, bound, *tol, max_iters=CLASSIFY_PLAIN_ITERS))
        check(all(same(a, b) for a, b in zip(cut_out[:3], loop[:3]))
              and torch.equal(cut_out[5], loop[5]),
              f"classify {name}: the interval kernel at the cut differs "
              "from the plain loop")
        ms = cuda_ms(lambda: interval(cap=CLASSIFY_PLAIN_ITERS),
                     INTERVAL_REPS)
        cut_trips = int(np.minimum(trips, CLASSIFY_PLAIN_ITERS).sum())
        live = int(torch.isfinite(y.mean(0)).sum())
        esz = y.element_size()
        b = bound_of_interval(n, live, cut_trips, esz, nbytes(bg.fields),
                              str(dt).split(".")[-1])
        run.kernels["interval"] = dict(
            max_abs_err=0.0, ms=ms, plain_ms=loop_s * 1e3,
            report_cap_ms=report_ms, chain_floor_ms=floor_ms,
            ms_by_instance=by_inst, library_ms=None, **b)
        run.launches["interval"] = launches["interval"]
        order = np.argsort(trips[~short], kind="stable")
        past = [(int(t), termination.CAUSES[i]) for t, i in zip(
            trips[~short][order], labels[~short][order])]
        print(f"{head}; cut at {CLASSIFY_PLAIN_ITERS} trips: kernels "
              f"{kc_s:.3f} s, plain RHS {p_s:.3f} s, labels, states and "
              f"trips bitwise on all {n} lanes; the report's labels and "
              f"states equal the plain ones on the {int(short.sum())} lanes "
              f"it finished within the cut; {len(past)} lanes past it "
              f"(trips, label): {past[:40]}")
        print(f"interval kernel ({inst}, {n} lanes, {int(trips.sum())} "
              f"trips, the longest {int(trips[lane])}): {report_ms:.3f} ms "
              f"at the report's cap; chain floor (lane {lane} alone) "
              f"{floor_ms:.3f} ms, "
              f"{floor_ms * 1e3 / max(int(trips[lane]), 1):.3f} us a trip; "
              "every instance bitwise, at the report's cap "
              + ", ".join(f"{k} {v:.3f} ms" for k, v in by_inst.items()))
        print(f"interval kernel cut at {CLASSIFY_PLAIN_ITERS} trips a lane "
              f"({cut_trips} trips): {ms:.3f} ms, the plain loop alone on "
              f"the same entry and cut {loop_s * 1e3:.1f} ms, bitwise; "
              f"bound {b['bound_ms']:.5f} ms ({b['bound_by']})")
    check(dead > 0, "classify: no dead ray re-run in either run")


def bound_of_interval(n, live, trips, esz, bg_bytes, unit):
    """The interval kernel's bound: y, t0, h and the bound in, y, t, h and
    the trips out, the background once; each live lane's entry evaluation
    and each trip's six evaluations and controller (ATTEMPT_FLOPS)."""
    return bound((8 + 7) * n * esz + 4 * n + bg_bytes,
                 live * RHS_FLOPS + trips * ATTEMPT_FLOPS, unit)


#: The group_time phase: lanes of the production seeding's entry state and
#: bounds of its one group, entered at day 0.5.
GROUP_TIME_LANES = 2048
GROUP_TIME_BOUNDS = 16


def phase_group_time(run):
    """ROADMAP item 18: the single-group kernels' time instances. Over the
    TV_DAYS + 1 daily frames and over two static "reanalysis year" members
    (a member map), float32, float64 and mixed: the first GROUP_TIME_LANES
    lanes of the production seeding's entry state, one GROUP_TIME_BOUNDS-
    bound group entered at day 0.5, through ``integrate_group_dense`` (pin
    (500, 0)) and ``integrate_group`` (exact), every counter reset just
    before each and read just after (one launch), every output bitwise
    equal to the plain loop on the card; the float32 time-varying cases
    timed against the plain loop."""
    torch = run.torch
    from rwrt_tpu_torch import tracer
    from rwrt_tpu_torch.models import ray
    from rwrt_tpu_torch.solvers import rk45

    f32, f64 = torch.float32, torch.float64
    n = GROUP_TIME_LANES
    for key, (sdt, fdt) in (("float32", (f32, f32)), ("float64", (f64, f64)),
                            ("mixed", (f64, f32))):
        _, y0, _, _, _ = run.entry(fdt, state=sdt)
        y0 = y0[:, :n].contiguous()
        tv = tracer.make_background(
            run.tv_bs if fdt == f32 else tv_state(run, TV_DAYS + 1, fdt), 0.0)
        years = [tracer.make_background(run.rt.prepare(
            u[0], v[0], lat, lon, cal_dtype=fdt, device=run.dev), 0.0)
            for u, v, lat, lon in (climatology_frames(1, sc, ph) for sc, ph
                                   in zip(MEMBER_SCALES[:2],
                                          MEMBER_PHASES[:2]))]
        members = years[0]._replace(
            fields=torch.stack([m.fields for m in years]).contiguous(),
            member_ids=torch.arange(n, dtype=torch.int32,
                                    device=run.dev) % 2)
        rtol = rk45.validate_tol(1e-6, sdt)
        atol = rk45.as_scalar(1e-6, sdt)
        min_step = rk45.as_scalar(1e-3 * 2 * HOUR, sdt)
        cut_off = rk45.as_scalar(0.1, sdt)
        for kind, bg in (("time", tv), ("member", members)):
            h0 = tracer.initial_step_sizes(bg, y0, rtol, atol)
            t0 = torch.full_like(h0, 0.5 * DAY)
            f0 = ray.RayRHS(bg)(y0, t0)
            bounds = (torch.arange(1, GROUP_TIME_BOUNDS + 1, dtype=sdt,
                                   device=run.dev) * (2 * HOUR) + 0.5 * DAY)

            def plain_rhs(yy, tt=0.0, bg=bg):
                return ray._rhs_core(bg, yy, tt, False)[0]

            def plain_gv(yy, tt=0.0, bg=bg):
                dy, _, ug, vg = ray._rhs_core(bg, yy, tt, True)
                return dy, ug, vg

            pin = dict(pin_limit=500, pin_mwn=0.0)
            dense_args = (y0, t0, h0, f0, bounds, rtol, atol, min_step)
            exact_args = (y0, t0, h0, f0, bounds, y0[0].clone(),
                          y0[1].clone(), cut_off, rtol, atol, min_step)
            units = {
                "dense_group": (
                    lambda bg=bg: rk45.integrate_group_dense(
                        ray.RayRHS(bg), *dense_args, **pin),
                    lambda: rk45._integrate_group_dense_plain(
                        plain_rhs, *dense_args, MAX_ITERS, **pin),
                    (0, 1, 2, 3, 4), (7, 8, 9), 5),
                "exact_group": (
                    lambda bg=bg: rk45.integrate_group(
                        ray.RayRHS(bg), None, *exact_args),
                    lambda: rk45._integrate_group_plain(
                        plain_rhs, plain_gv, *exact_args),
                    range(7), (9, 10, 11, 12), 7),
            }
            for unit, (kernel, plain, floats, ints, iters) in units.items():
                torch.cuda.synchronize()
                reset_launches()
                kern = kernel()
                launches = read_launches(unit, 1, f"{unit} {kind} {key}")
                (pl, p_s) = wall_s(plain)
                tag = f"group_time {unit} {kind} {key}"
                for i in floats:
                    check(kern[i].dtype == pl[i].dtype
                          and same(kern[i], pl[i]),
                          f"{tag}: output {i} differs from the plain loop")
                for i in ints:
                    check(torch.equal(kern[i], pl[i]),
                          f"{tag}: output {i} differs from the plain loop")
                check(int(kern[iters]) == pl[iters], f"{tag}: iters")
                if key != "float32" or kind != "time":
                    continue
                ms = cuda_ms(kernel, 5)
                attempts = int(kern[7 if unit == "dense_group" else 9].sum())
                tsf = 6 * attempts * time_sample_flops(bg)
                if unit == "dense_group":
                    rows = int(kern[0][:, 0].isfinite().sum())
                    flops = attempts * ATTEMPT_FLOPS + rows * ROW_FLOPS + tsf
                    out = (kern[0], *kern[1:5], kern[7], kern[8], kern[9])
                else:
                    rows = int(kern[0][:, 5].isfinite().sum())
                    flops = (attempts * EXACT_ATTEMPT_FLOPS
                             + rows * KILL_FLOPS + tsf)
                    out = kern[:7] + kern[9:]
                b = bound(nbytes(bg.fields, y0, t0, h0, f0, bounds, *out),
                          flops, "float32")
                print(f"{tag}: R={n}, {GROUP_TIME_BOUNDS} bounds, bitwise "
                      f"equal to the plain loop; step attempts {attempts}; "
                      f"kernel {ms:.3f} ms (CUDA events), plain "
                      f"{p_s * 1e3:.1f} ms, bound {b['bound_ms']:.4f} ms "
                      f"({b['bound_by']})")
                name = f"{unit}_time"
                run.kernels[name] = dict(max_abs_err=0.0, ms=ms,
                                         plain_ms=p_s * 1e3, library_ms=None,
                                         **b)
                run.launches[name] = launches[unit]
    print(f"group_time: both single-group kernels' time instances bitwise "
          f"equal to the plain loops over daily frames and two members, in "
          f"float32, float64 and mixed ({n} lanes)")


#: The gather phase: trials of GATHER_REPS launches each, the median
#: trial's mean taken.
GATHER_REPS = 20
GATHER_TRIALS = 5


def median_ms(fn, reps=GATHER_REPS, trials=GATHER_TRIALS):
    """The median over ``trials`` of ``cuda_ms(fn, reps)``."""
    return float(np.median([cuda_ms(fn, reps) for _ in range(trials)]))


def phase_gather(run):
    """The last TPU kernel's path, the gather probe
    (``python -m rwrt_tpu_torch.probes.gather_probe``, the JAX probe's
    shapes: R = 131,072 int32 indices into a (145 * 73, width) float32
    table, seed 0): its entry point ``probe`` with every counter at 0 just
    before and read just after (the kernel launched in every link of every
    timed chain), printing ms and ns per row of each gather in the 30-link
    chain at widths 48, 128 and 384. Then at each width: the kernel through
    ``gather_rows`` bitwise equal to ``gather_rows_plain``
    (``index_select``); the kernel alone (a preallocated output), the
    wrapper, the plain version, ``table[idx]`` and ``index_select`` on the
    int32 indices, each the median of GATHER_TRIALS means of GATHER_REPS
    launches (CUDA events); the bound: the output written, the indices and
    the table read once, over the memory rate."""
    torch = run.torch
    from rwrt_tpu_torch import kernels
    from rwrt_tpu_torch.probes import gather_probe as gp

    torch.cuda.synchronize()
    reset_launches()
    chains = gp.probe(run.dev)
    torch.cuda.synchronize()
    # Each chain timing: one warm-up and five timed chains of N links.
    launches = read_launches("gather", len(gp.WIDTHS) * 6 * gp.N,
                             "the gather probe")
    run.launches["gather"] = launches["gather"]

    idx, tables = gp.inputs(run.dev)
    r = idx.shape[0]
    for width in gp.WIDTHS:
        table = tables[width]
        k = gp.gather_rows(table, idx)
        p = gp.gather_rows_plain(table, idx)
        torch.cuda.synchronize()
        check(torch.equal(k, p),
              f"gather width {width}: the kernel differs from index_select")
        out = torch.empty_like(k)
        stream = kernels.stream(run.dev)
        alone = median_ms(lambda: kernels.launch(
            "rwrt_gather", table.dtype, table, width, idx, r, out, stream))
        wrapper = median_ms(lambda: gp.gather_rows(table, idx))
        plain = median_ms(lambda: gp.gather_rows_plain(table, idx))
        index = median_ms(lambda: table[idx])
        select = median_ms(lambda: table.index_select(0, idx))
        b = bound(nbytes(k, idx, table), 0, "float32")
        ns = {n: chains[(n, width)] * 1e6 / r for n in gp.GATHERS}
        print(f"gather width {width}: R={r}, bitwise equal to index_select; "
              f"kernel alone {alone:.4f} ms, wrapper {wrapper:.4f} ms, "
              f"plain (index_select of int64 indices) {plain:.4f} ms, "
              f"table[idx] {index:.4f} ms, index_select {select:.4f} ms, "
              f"bound {b['bound_ms']:.4f} ms ({b['bound_by']}); chain of "
              f"{gp.N}: " + ", ".join(f"{n} {v:.2f} ns/row"
                                      for n, v in ns.items()))
        if width == 48:
            run.kernels["gather"] = dict(max_abs_err=0.0, ms=alone,
                                         plain_ms=plain, library_ms=select,
                                         **b)


#: The autodiff phase: the central differences' step and bars (as
#: tests/test_autodiff.py), the targeting run (a 20 x 20 lattice of seeds,
#: 10-60 N, every 18 degrees of longitude, x zwn 1..7: 8,400 rays, 30 days
#: at 2 h, Adam), its target (120 W, 45 N) and the seeds whose coordinates
#: its gradient is held to central differences at: seeds off the 2.5-degree
#: grid's lines (the bilinear sample is piecewise linear, so on a grid line
#: the gradient is one side's slope and a central difference the mean of
#: both: the lattice's longitudes 0, 90, 180, 270 and latitudes 10, 60 lie
#: on lines). The central differences gate the gradient over the first
#: AD_FD_DAYS days of the run; over AD_DAYS days a step of AD_EPS strays
#: from the gradient (rays killed or frozen on one side of the stencil and
#: not the other, and 30 days of the rays' sensitivity), so there they are
#: printed beside it and not gated.
AD_EPS = 1e-6
AD_BARS = {"wind": 1e-6, "seed": 1e-5, "targeting": 1e-5}
AD_LATTICE = 20
AD_DAYS = 30
#: Adam steps: 3, cut from the 10 a user's run would take to keep the
#: script well inside its time limit (15.7-22.9 s a step on an H100, the
#: host's Python dispatch setting the pace).
AD_STEPS = 3
AD_LR = 0.02
AD_TAU = 0.05
AD_TARGET = (240.0, 45.0)
AD_CHECK_SEEDS = (21, 133, 266, 378)
AD_FD_DAYS = 5


def phase_autodiff(run):
    """Gradients on the card through the plain, differentiable route (no
    kernel: every counter set to 0 at the start and read at the end), on
    the climatology in float64: d(final lat)/d(wind scale) through
    ``prepare`` -> ``make_background`` -> ``initialize`` -> 24 RK4 steps
    and d/d(seed lat), against central differences (AD_EPS, AD_BARS);
    ``optimize_seeds`` at the size a user runs it (AD_LATTICE^2 seeds x zwn
    1..7, AD_DAYS days, AD_STEPS Adam steps): its gradient before the
    first step finite and, at AD_CHECK_SEEDS' coordinates over the first
    AD_FD_DAYS days, equal to central differences (over AD_DAYS days
    printed beside them), its objective falling, its wall per step, peak
    device memory and the miss before and after. Last, ``trace_rays`` over
    a state with a graph raises at the kernel guard."""
    torch = run.torch
    from rwrt_tpu_torch import tracer
    from rwrt_tpu_torch.diagnostics import targeting
    from rwrt_tpu_torch.solvers import rk4

    f64, dev = torch.float64, run.dev
    u, v = (torch.as_tensor(x, dtype=f64, device=dev)
            for x in (run.u, run.v))

    def t64(x):
        return torch.as_tensor(x, dtype=f64, device=dev)

    def final_lat(amp, slat):
        bs = run.rt.prepare(amp * u, v, run.lat, run.lon, read_dtype=f64,
                            cal_dtype=f64, device=dev)
        bg = tracer.make_background(bs, 0.0)
        y0, _, _ = tracer.initialize(bg, t64([0.3]), slat.reshape(1),
                                     t64([4.0]))
        ys, _, _ = rk4.trace(bg, y0, 2 * HOUR, 25, 0.2)
        return ys[-1, 1, 0]

    torch.cuda.synchronize()
    reset_launches()
    for name, at in (("wind", 0), ("seed", 1)):
        x = [t64(1.0), t64(0.25)]
        x[at] = x[at].clone().requires_grad_(True)
        (g,) = torch.autograd.grad(final_lat(*x), x[at])
        with torch.no_grad():
            hi, lo = [t64(1.0), t64(0.25)], [t64(1.0), t64(0.25)]
            hi[at] = hi[at] + AD_EPS
            lo[at] = lo[at] - AD_EPS
            fd = float(final_lat(*hi) - final_lat(*lo)) / (2 * AD_EPS)
        g = float(g)
        err = abs(g - fd) / max(1.0, abs(fd))
        print(f"autodiff d(final lat)/d({name}) over 24 RK4 steps on the "
              f"card: {g:.12e}, central difference {fd:.12e}, error "
              f"{err:.3e} (bar {AD_BARS[name]:g})")
        check(math.isfinite(g) and err <= AD_BARS[name],
              f"autodiff d/d({name}) {g} against {fd}")

    # The targeting run.
    bs = run.rt.prepare(run.u, run.v, run.lat, run.lon, read_dtype=f64,
                        cal_dtype=f64, device=dev)
    bg = tracer.make_background(bs, 0.0)
    lon_g, lat_g = np.meshgrid(np.radians(np.arange(AD_LATTICE) * 18.0),
                               np.radians(np.linspace(10.0, 60.0,
                                                      AD_LATTICE)))
    slon0, slat0 = lon_g.ravel(), lat_g.ravel()
    ns = slon0.shape[0]
    zwn = tuple(float(z) for z in range(1, 8))
    target = tuple(np.radians(AD_TARGET))
    nt = int(round(AD_DAYS * DAY / (2 * HOUR))) + 1
    kw = dict(nt=nt, dt=2 * HOUR, cut_off=0.2)

    def miss(lon, lat, tau=AD_TAU):
        return targeting.miss_distance(bg, lon, lat, zwn, *target, tau=tau,
                                       **kw)

    sl = t64(slon0).requires_grad_(True)
    sb = t64(slat0).requires_grad_(True)

    def against_fd(days, gate, grads=None):
        """The gradient of the mean miss over ``days`` days (or ``grads``,
        that gradient already taken), and its seeds' central differences
        (each seed's miss depends on its own coordinates alone, so one pair
        of runs with every seed moved gives them all); with ``gate``, fails
        unless AD_CHECK_SEEDS' agree."""
        kd = dict(kw, nt=int(round(days * DAY / (2 * HOUR))) + 1)

        def m(lon, lat):
            return targeting.miss_distance(bg, lon, lat, zwn, *target,
                                           tau=AD_TAU, **kd)

        if grads is None:
            grads = torch.autograd.grad(m(sl, sb).mean(), (sl, sb))
        check(all(bool(torch.isfinite(gr).all()) for gr in grads),
              f"the targeting gradient over {days} days is not finite")
        sel = list(AD_CHECK_SEEDS)
        for name, at in (("lon", 0), ("lat", 1)):
            with torch.no_grad():
                ends = []
                for sign in (1.0, -1.0):
                    xs = [sl.detach(), sb.detach()]
                    xs[at] = xs[at] + sign * AD_EPS
                    ends.append(m(*xs))
            fd = (ends[0] - ends[1]) / (2 * AD_EPS)
            g = grads[at] * ns  # the objective is the mean over seeds
            err = torch.abs(g - fd) / torch.clamp(torch.abs(fd), min=1.0)
            agree = int((err <= AD_BARS["targeting"]).sum())
            print(f"autodiff targeting over {days} days, d(miss)/d({name}) "
                  f"at seeds {sel}: {g[sel].tolist()}, central differences "
                  f"{fd[sel].tolist()}, max error {float(err[sel].max()):.3e}"
                  f" (bar {AD_BARS['targeting']:g}, "
                  f"{'gated' if gate else 'not gated'}); {agree} of {ns} "
                  "seeds within the bar")
            check(not gate or float(err[sel].max()) <= AD_BARS["targeting"],
                  f"autodiff targeting d/d({name}) over {days} days differs "
                  "from central differences")

    def gradient():
        return torch.autograd.grad(miss(sl, sb).mean(), (sl, sb))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    grads, grad_s = wall_s(gradient)
    grad_peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    with torch.no_grad():
        miss0 = miss(sl, sb, None)
    against_fd(AD_FD_DAYS, True)
    against_fd(AD_DAYS, False, grads)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    res, opt_s = wall_s(lambda: targeting.optimize_seeds(
        bs, slon0, slat0, zwn, *target, steps=AD_STEPS,
        learning_rate=AD_LR, tau=AD_TAU, **kw))
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    hist = res.history
    check(np.isfinite(hist).all() and hist[-1] < hist[0],
          f"optimize_seeds' objective did not fall: {hist.tolist()}")
    deg = 180.0 / math.pi
    print(f"autodiff optimize_seeds: {ns} seeds x {len(zwn)} zwn x 3 roots "
          f"= {3 * ns * len(zwn)} rays, {nt - 1} RK4 steps, {AD_STEPS} Adam "
          f"steps: objective {hist[0]:.6f} -> {hist[-1]:.6f} rad; hard-min "
          f"miss mean {float(miss0.mean()) * deg:.3f} -> "
          f"{float(res.miss.mean()) * deg:.3f} deg, median "
          f"{float(miss0.median()) * deg:.3f} -> "
          f"{float(res.miss.median()) * deg:.3f} deg; one gradient "
          f"(forward and reverse) {grad_s:.2f} s, peak {grad_peak:.2f} GiB "
          f"above the state; optimize_seeds {opt_s:.2f} s "
          f"({opt_s / AD_STEPS:.2f} s per Adam step, its final forward "
          f"passes included), peak {peak:.2f} GiB")
    read_launches({"rhs": 0}, 0, "the autodiff phase")

    # The guard: a state whose fields carry a graph, into the kernels.
    ut = u.clone().requires_grad_(True)
    bs_g = run.rt.prepare(ut, run.v, run.lat, run.lon, read_dtype=f64,
                          cal_dtype=f64, device=dev)
    for cfg in (run.rt.RunConfig(nnx=3, nny=3, ttotal=4 * 2 * HOUR,
                                 cal_dtype="float64"),
                run.rt.RunConfig(nnx=3, nny=3, ttotal=4 * 2 * HOUR,
                                 integrator="rk45", cal_dtype="float64")):
        try:
            run.rt.trace_rays(bs_g, cfg)
            refused = None
        except RuntimeError as e:
            refused = e
        check(refused is not None and "differentiable route" in str(refused),
              f"trace_rays ({cfg.integrator}) took a gradient-carrying "
              f"state: {refused!r}")
    print("autodiff: trace_rays over a gradient-carrying state raises at "
          "the kernel guard (rk4 and rk45)")


#: The examples phase: each port example's time limit (s), and the
#: great-circle demo's alive count at full size (the JAX package's demo,
#: ``examples/great_circle_demo.py``, on the CPU: every one of its rays).
EXAMPLE_TIMEOUT = 300
GREAT_CIRCLE_RAYS = 75


def run_examples(run, *calls):
    """``examples/torch_<name>.py`` with its args and ``--device cuda``,
    for each (name, *args) of ``calls``, in subprocesses started together,
    at full size, under the run's temporary directory; raises unless each
    exits 0. Returns their stdouts."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    env.pop("RWRT_SMOKE", None)
    cwd = Path(run.tmp) / "examples"
    cwd.mkdir(exist_ok=True)
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, str(REPO / "examples" / f"torch_{name}.py"), *args,
         "--device", "cuda"], cwd=cwd, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for name, *args in calls]
    outs = []
    try:
        for (name, *_), proc in zip(calls, procs):
            out, err = proc.communicate(timeout=EXAMPLE_TIMEOUT)
            wall = time.perf_counter() - t0
            check(proc.returncode == 0, f"examples/torch_{name}.py exited "
                  f"{proc.returncode}:\n{out}\n{err}")
            print(f"example torch_{name}.py: ended {wall:.1f} s after the "
                  "examples' start")
            for line in out.strip().splitlines():
                print(f"  {line}")
            outs.append(out)
    finally:
        for proc in procs:       # after a failure: stop the others
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return outs


def example_numbers(pattern, text):
    m = re.search(pattern, text)
    check(m is not None, f"{pattern!r} not in the example's output")
    return m.groups()


def phase_examples(run):
    """The port's examples (``examples/torch_*.py``) on the card, each in
    its own process with ``--device cuda`` (started together), at full
    size: the great-circle demo (every ray alive at day 30, as in the JAX
    package's demo) and the plot script on its file, the flux demo (its
    termination counts sum to the rays seeded, points binned), the adjoint
    demo (both gradients against its central differences within
    AD_BARS). Prints when each one ended. The targeting demo is not run here: at ``RWRT_SMOKE=1`` it took
    over 60 s on the card (the autodiff phase drives ``optimize_seeds``
    there at a user's size); tests/test_torch_examples.py runs it."""
    out, flux, adjoint = run_examples(
        run, ("great_circle_demo",), ("flux_diagnostics_demo",),
        ("adjoint_sensitivity",))
    shape, alive = example_numbers(
        r"integrated \((.*)\) trajectories; (\d+) alive at end", out)
    check(int(alive) == GREAT_CIRCLE_RAYS,
          f"great circle: {alive} rays alive, not {GREAT_CIRCLE_RAYS}")
    traj = Path(run.tmp) / "examples" / "rays_great_circle.npz"
    png = Path(run.tmp) / "examples" / "rays.png"
    if importlib.util.find_spec("matplotlib") is None:
        # The plot script draws on the host with matplotlib, which a GPU
        # machine need not have; tests/test_torch_examples.py runs it.
        print("example torch_plot_trajectories.py: not run, matplotlib is "
              "not installed here")
    else:
        run_examples(run, ("plot_trajectories", str(traj), str(png)))
        check(png.stat().st_size > 0, "the plot script wrote no image")

    counts = json.loads(example_numbers(
        r"termination counts: (\{.*\})", flux)[0].replace("'", '"'))
    binned = int(example_numbers(r"trajectory points binned: ([\d,]+)",
                                 flux)[0].replace(",", ""))
    rays = 3 * 18 * 7 * 5
    check(sum(counts.values()) == rays and binned > 0,
          f"flux demo: counts {counts} over {rays} rays, {binned} binned")

    for what, bar in (("jet scale", AD_BARS["wind"]),
                      ("seed lat", AD_BARS["seed"])):
        g, fd = map(float, example_numbers(
            r"d\(final lat\)/d\(" + what + r"\):\s+grad (\S+)\s+fd (\S+)",
            adjoint))
        check(math.isfinite(g) and abs(g - fd) <= bar * max(1.0, abs(fd)),
              f"adjoint demo d/d({what}): grad {g} against fd {fd}")


KERNELS = (
    ("rhs", "rwrt_tpu_torch/csrc/rhs.cu", "rwrt_tpu/models/ray.py:163"),
    ("dense_group", "rwrt_tpu_torch/csrc/dense_run.cu",
     "rwrt_tpu/solvers/rk45.py:494"),
    ("dense_run", "rwrt_tpu_torch/csrc/dense_run.cu",
     "rwrt_tpu/tracer.py:861"),
    ("spectral", "rwrt_tpu_torch/csrc/spectral.cu",
     "rwrt_tpu/ops/spectral_sample.py:324"),
    ("rk4_run", "rwrt_tpu_torch/csrc/rk4_run.cu", "rwrt_tpu/tracer.py:819"),
    ("exact_group", "rwrt_tpu_torch/csrc/exact_run.cu",
     "rwrt_tpu/solvers/rk45.py:302"),
    ("exact_run", "rwrt_tpu_torch/csrc/exact_run.cu",
     "rwrt_tpu/tracer.py:861"),
    ("dense_run_mix", "rwrt_tpu_torch/csrc/dense_run_mix.cu",
     "rwrt_tpu/tracer.py:861"),
    ("rk4_run_mix", "rwrt_tpu_torch/csrc/rk4_run_mix.cu",
     "rwrt_tpu/tracer.py:819"),
    ("exact_run_mix", "rwrt_tpu_torch/csrc/exact_run_mix.cu",
     "rwrt_tpu/tracer.py:861"),
    ("dense_group_mix", "rwrt_tpu_torch/csrc/dense_run_mix.cu",
     "rwrt_tpu/solvers/rk45.py:494"),
    ("exact_group_mix", "rwrt_tpu_torch/csrc/exact_run_mix.cu",
     "rwrt_tpu/solvers/rk45.py:302"),
    ("rhs_time", "rwrt_tpu_torch/csrc/rhs_time.cu",
     "rwrt_tpu/models/ray.py:163"),
    ("dense_run_time", "rwrt_tpu_torch/csrc/dense_run_time.cu",
     "rwrt_tpu/tracer.py:861"),
    ("rk4_run_time", "rwrt_tpu_torch/csrc/rk4_run_time.cu",
     "rwrt_tpu/tracer.py:819"),
    ("rk4_run_time_mix", "rwrt_tpu_torch/csrc/rk4_run_time_mix.cu",
     "rwrt_tpu/tracer.py:819"),
    ("rk4_run_time_f64", "rwrt_tpu_torch/csrc/rk4_run_time.cu",
     "rwrt_tpu/tracer.py:819"),
    ("exact_run_time", "rwrt_tpu_torch/csrc/exact_run_time.cu",
     "rwrt_tpu/tracer.py:861"),
    ("exact_run_time_mix", "rwrt_tpu_torch/csrc/exact_run_time_mix.cu",
     "rwrt_tpu/tracer.py:861"),
    ("exact_run_time_f64", "rwrt_tpu_torch/csrc/exact_run_time_f64.cu",
     "rwrt_tpu/tracer.py:861"),
    ("dense_run_time_mix", "rwrt_tpu_torch/csrc/dense_run_time_mix.cu",
     "rwrt_tpu/tracer.py:861"),
    ("dense_run_time_f64", "rwrt_tpu_torch/csrc/dense_run_time_f64.cu",
     "rwrt_tpu/tracer.py:861"),
    ("dense_run_member", "rwrt_tpu_torch/csrc/dense_run_time.cu",
     "rwrt_tpu/tracer.py:1367"),
    ("rk4_run_member_time", "rwrt_tpu_torch/csrc/rk4_run_time.cu",
     "rwrt_tpu/tracer.py:1367"),
    ("exact_run_member_time_f64", "rwrt_tpu_torch/csrc/exact_run_time_f64.cu",
     "rwrt_tpu/tracer.py:1367"),
    ("flux", "rwrt_tpu_torch/csrc/flux.cu",
     "rwrt_tpu/diagnostics/flux.py:279"),
    ("interval", "rwrt_tpu_torch/csrc/interval.cu",
     "rwrt_tpu/solvers/rk45.py:130"),
    ("flux_region", "rwrt_tpu_torch/csrc/flux.cu",
     "rwrt_tpu/diagnostics/flux.py:104"),
    ("dense_group_time", "rwrt_tpu_torch/csrc/dense_run_time.cu",
     "rwrt_tpu/solvers/rk45.py:494"),
    ("exact_group_time", "rwrt_tpu_torch/csrc/exact_run_time.cu",
     "rwrt_tpu/solvers/rk45.py:302"),
    ("gather", "rwrt_tpu_torch/csrc/gather.cu",
     "benchmarks/pallas_gather_probe.py:77"),
    ("entry", "rwrt_tpu_torch/csrc/entry.cu", "rwrt_tpu/tracer.py:809"),
    ("entry_time", "rwrt_tpu_torch/csrc/entry_time.cu",
     "rwrt_tpu/tracer.py:809"),
)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (REPO / "rwrt_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: rwrt_tpu_torch/ not found beside {__file__}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    import rwrt_tpu_torch as rt
    from rwrt_tpu_torch import kernels

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0])
    print(f"torch {torch.__version__} cuda {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    kernels.library()
    print(f"build {time.perf_counter() - t0:.1f} s")

    run = Run(torch, rt)
    tmp = tempfile.TemporaryDirectory()
    run.tmp = tmp.name
    for phase in (phase_plain_ahead, phase_rhs, phase_dense_group, phase_dense_run,
                  phase_dense_lone_lane, phase_main_path, phase_entry,
                  phase_spectral,
                  phase_rk4, phase_exact_group, phase_exact_run,
                  phase_rk4_path, phase_exact_path, phase_chunked,
                  phase_mixed_dense, phase_mixed_drift, phase_mixed_rk4,
                  phase_mixed_exact, phase_mixed_chunked, phase_time_rhs,
                  phase_time_main_path, phase_time_entry, phase_time_paths,
                  phase_time_chunked,
                  phase_ensemble, phase_mesh, phase_time_spectral, phase_cli,
                  phase_flux,
                  phase_wrf_cli, phase_classify, phase_group_time,
                  phase_gather, phase_autodiff, phase_examples):
        t0 = time.perf_counter()
        phase(run)
        print(f"phase {phase.__name__[6:]} ok in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    tmp.cleanup()

    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=src, replaces=rep,
             launches=run.launches[name], **run.kernels[name])
        for name, src, rep in KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--plain"]:
        sys.exit(plain_worker(Path(sys.argv[2]), sys.argv[3:]))
    sys.exit(main())
