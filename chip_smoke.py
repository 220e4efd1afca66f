#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one CUDA card.

    python3 chip_smoke.py

Builds the port's kernels from ``rwrt_tpu_torch/csrc/``, holds each kernel
against its plain PyTorch version on the card, then runs the production
workload through ``rwrt_tpu_torch.trace_rays``: the 144 x 73 climatology
background, 4800 random sources x zwn 1..7 = 100,800 rays, 30 days at a 2 h
cadence, dense adaptive RK45 with pin-kill (500, 0), float32, and samples
the spectral fit of the same background at the day-10 positions.

Phases (any failed check raises; nothing is caught):
  rhs          ``ray.rhs`` and ``ray.rhs_and_gv`` (the kernel) vs the
               plain ``ray._rhs_core`` on 100,800 seeded states
  dense_group  one 60-bound group on the 100,800-ray seed batch, kernel vs
               the plain loop, float64 and float32
  main_path    the run above through ``trace_rays``, launch counters reset
               just before it and read just after; then a sampler stage
               (the spectral kernel at the day-10 positions) with its own
               counter, since ``trace_rays`` never calls the sampler
  spectral     spectral kernel vs ``sample_spectral`` at the day-10
               positions, float64, float64 with bf16 operands, float32 and
               float32 with bf16 operands; kernel-alone, wrapper (with the
               coefficient repack) and plain times, achieved TFLOP/s

Prints the card (``nvidia-smi`` name and power limit), per-phase numbers,
one ``{"kernels": [...]}`` JSON line and, last, the ``{"ok": true, ...}``
JSON line. Exits nonzero without a result when no CUDA device is present or
when the port's package is not beside this script. Imports no JAX.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
DAY = 86400.0
HOUR = 3600.0
#: The production workload (the repo benchmark's seeding and horizon).
N_SOURCES = 4800
N_DAYS = 30


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


def production_config(rt):
    """The production run's RunConfig (sources are passed separately)."""
    return rt.RunConfig(
        zwn=tuple(float(z) for z in range(1, 8)), tstep=2 * HOUR,
        ttotal=N_DAYS * DAY, integrator="rk45", bound_mode="dense",
        interval_batch=60, rtol=1e-6, atol=1e-6, min_step_factor=1e-3,
        cut_off=0.1, pin_limit=500, pin_mwn=0.0, cal_dtype="float32")


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


def same_nan(a, b):
    import torch

    return bool(torch.equal(torch.isnan(a), torch.isnan(b)))


def rel_err(a, b, dim):
    """max |a - b| / max |a| along ``dim``, NaN entries excluded."""
    import torch

    d = torch.nan_to_num(torch.abs(a - b), nan=0.0)
    s = torch.nan_to_num(torch.abs(a), nan=0.0).amax(dim=dim, keepdim=True)
    return float((d / torch.clamp(s, min=1e-300)).max())


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

    def bs(self, dtype):
        return self.rt.prepare(self.u, self.v, self.lat, self.lon,
                               cal_dtype=dtype, device=self.dev)

    def seed_batch(self, dtype):
        from rwrt_tpu_torch import tracer

        bs = self.bs(dtype)
        bg = tracer.make_background(bs, 0.0)
        t = self.torch
        y0, _, _ = tracer.initialize(
            bg, t.as_tensor(self.slon, dtype=dtype, device=self.dev),
            t.as_tensor(self.slat, dtype=dtype, device=self.dev),
            t.arange(1, 8, dtype=dtype, device=self.dev))
        return bs, bg, y0.contiguous()


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
        _, bg, _ = run.seed_batch(dtype)
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
            plain = cuda_ms(lambda: ray._rhs_core(bg, yt, 0.0, False), 20)
            print(f"rhs time at R={n}: kernel {ms:.4f} ms, plain {plain:.4f} ms")
            run.kernels["rhs"] = dict(
                max_abs_err=float(torch.nan_to_num(
                    torch.abs(k[0] - p[0]), nan=0.0).max()),
                ms=ms, plain_ms=plain)


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
        bs, bg, y0 = run.seed_batch(dtype)
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
            plain_ms = cuda_ms(run_plain, 1)
            print(f"  float32 device time (CUDA events): kernel {ms:.3f} ms, "
                  f"plain {plain_ms:.1f} ms")
            run.kernels["dense_group"] = dict(
                max_abs_err=float(dpos.max()), ms=ms, plain_ms=plain_ms)


def phase_main_path(run):
    torch = run.torch
    from rwrt_tpu_torch.models import ray
    from rwrt_tpu_torch.ops import spectral_sample as spec
    from rwrt_tpu_torch.solvers import rk45

    cfg = production_config(run.rt)
    bs = run.bs(torch.float32)
    sbg = spec.fit_spectral(bs)
    torch.cuda.synchronize()

    # Step attempts: each group's per-lane counts, kept on the card and
    # summed once after the run, so the count adds no host read per group.
    lane_atts = []
    integrate = rk45.integrate_group_dense

    def counted(*args, **kw):
        out = integrate(*args, **kw)
        lane_atts.append(out[7])
        return out

    rk45.integrate_group_dense = counted
    try:
        ray.LAUNCHES = rk45.LAUNCHES = spec.LAUNCHES = 0
        t0 = time.perf_counter()
        traj = run.rt.trace_rays(bs, cfg, source_lon=run.slon,
                                 source_lat=run.slat)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"rhs": ray.LAUNCHES, "dense_group": rk45.LAUNCHES,
                    "spectral": spec.LAUNCHES}
    finally:
        rk45.integrate_group_dense = integrate
    attempts = int(sum(int(a.sum()) for a in lane_atts))
    check(launches["spectral"] == 0, "trace_rays launched the spectral kernel")
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
    for k, n in launches.items():
        check(n > 0, f"{k} kernel was not launched")
    alive = {d: float(torch.isfinite(traj.ky[12 * d]).float().mean())
             for d in (10, 20, 30) if 12 * d < nt}
    rate = n_rays * (nt - 1) / wall
    print(f"main_path ray-steps/s {rate:.1f}")
    print(f"main_path: {n_rays} rays x {N_DAYS} days, wall {wall:.3f} s, "
          f"alive fraction by day {alive}, step attempts {attempts}")
    print(f"launches: trace_rays rhs {launches['rhs']}, dense_group "
          f"{launches['dense_group']}; sampler stage after it: spectral "
          f"{launches['spectral']} at {pos[0].shape[0]} day-10 points")
    run.launches = launches
    run.day10 = pos


def phase_spectral(run):
    torch = run.torch
    from rwrt_tpu_torch.ops import spectral_sample as spec

    lon, lat = run.day10
    extra_lon = torch.tensor([0.3, float("nan"), 1.0], device=run.dev)
    extra_lat = torch.tensor([2.0, 0.1, -1.7], device=run.dev)
    for dtype, bar, mm in ((torch.float64, 1e-12, None),
                           (torch.float64, 1e-12, torch.bfloat16),
                           (torch.float32, 1e-5, None),
                           (torch.float32, 1e-5, torch.bfloat16)):
        sbg = spec.fit_spectral(run.bs(dtype))
        check(tuple(sbg.coeffs.shape) == (145, 73, 18),
              f"coefficients {tuple(sbg.coeffs.shape)}")
        lo = torch.cat([lon.to(dtype), extra_lon.to(dtype)])
        la = torch.cat([lat.to(dtype), extra_lat.to(dtype)])
        k = spec.sample_spectral_cuda(sbg, lo, la, matmul_dtype=mm)
        p = spec.sample_spectral(sbg, lo, la, matmul_dtype=mm)
        k2 = spec.sample_spectral_cuda(sbg, lo, la, matmul_dtype=mm)
        torch.cuda.synchronize()
        tag = str(dtype)[6:] + ("_bf16" if mm is not None else "")
        check(same_nan(k, p), f"spectral NaN rows differ ({tag})")
        check(bool(torch.isnan(k[-3:]).all()), "spectral NaN rows missing")
        check(torch.equal(torch.nan_to_num(k), torch.nan_to_num(k2)),
              f"spectral {tag}: two launches differ")
        e = rel_err(p.T, k.T, dim=1)
        # The kernel alone, on operands the wrapper would prepare.
        bf16 = mm is not None
        packed = spec.pack_coeffs(sbg.coeffs, bf16)
        tht = (la - sbg.lat0).contiguous()
        out = torch.empty_like(k)
        kern = cuda_ms(lambda: spec.launch_kernel(
            packed, lo, la, tht, sbg.coeffs.shape, bf16, out), 20)
        ms = cuda_ms(lambda: spec.sample_spectral_cuda(
            sbg, lo, la, matmul_dtype=mm), 20)
        plain = cuda_ms(lambda: spec.sample_spectral(
            sbg, lo, la, matmul_dtype=mm), 5)
        flop = 2.0 * lo.shape[0] * math.prod(sbg.coeffs.shape)
        print(f"spectral {tag}: R={lo.shape[0]}, max err / channel max "
              f"{e:.3e} (bar {bar:g}), kernel alone {kern:.4f} ms "
              f"({flop / kern * 1e-9:.1f} TFLOP/s), wrapper {ms:.4f} ms, "
              f"plain {plain:.4f} ms")
        check(e <= bar, f"spectral {tag} error {e} > {bar}")
        if tag == "float32":
            run.kernels["spectral"] = dict(
                max_abs_err=float(torch.nan_to_num(
                    torch.abs(k - p), nan=0.0).max()),
                ms=ms, plain_ms=plain)


KERNELS = (
    ("rhs", "rwrt_tpu_torch/csrc/rhs.cu", "rwrt_tpu/models/ray.py:163"),
    ("dense_group", "rwrt_tpu_torch/csrc/dense_group.cu",
     "rwrt_tpu/solvers/rk45.py:494"),
    ("spectral", "rwrt_tpu_torch/csrc/spectral.cu",
     "rwrt_tpu/ops/spectral_sample.py:324"),
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
    for phase in (phase_rhs, phase_dense_group, phase_main_path,
                  phase_spectral):
        t0 = time.perf_counter()
        phase(run)
        print(f"phase {phase.__name__[6:]} ok in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)

    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=src, replaces=rep,
             launches=run.launches[name], **run.kernels[name])
        for name, src, rep in KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
