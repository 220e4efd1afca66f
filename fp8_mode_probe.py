#!/usr/bin/env python3
"""Measure the spectral sampler on Hopper's fp8 tensor cores against the bar.

    python3 fp8_mode_probe.py [--reps 20]
                              [--out DIR (rwrt_tpu_torch/_build/fp8_probe)]

Needs one CUDA card (sm_90a) and nvcc. Builds ``fp8_mode_probe.cu`` (the
package's ``csrc/spectral.cu`` with a wgmma e4m3 / e5m2 format added; not
part of the package) into ``rwrt_tpu_torch/_build/fp8_probe/<hash>/``,
beside ``spectral_fp8.cu``: ``csrc/spectral.cu`` with the enumerators
``kFp8E4M3`` and ``kFp8E5M2`` added to its ``Mode`` (nvcc's host stubs
name a template's enum argument by its enumerator), then, on chip_smoke.py's spectral inputs (the climatology's float32 fit,
sampled at the production run's day-10 positions as chip_smoke's
main_path leaves them, plus its three NaN / out-of-range rows), for
float8_e4m3fn and float8_e5m2 operands:

- the fp8 mode's error against the plain ``sample_spectral`` with the same
  ``matmul_dtype`` (the largest |diff| over each channel's max, the
  sampler's 1e-5 bar beside it), non-finite positions equal, two launches
  bitwise;
- its kernel alone (CUDA events, the mean of ``--reps`` launches after one)
  beside the package's kernel alone on the same inputs (the bf16 MMA,
  exact), in turns package / fp8 / fp8 / package.

The tiles are packed on the host from ``pack_coeffs``' (the same rounded
values, as float8 bytes in wgmma's core-matrix order). Prints the card's
name and power limit, one JSON line per case, and writes them to
``DIR/fp8_probe.jsonl``. Exits 0 when both cases ran, whether or not the
mode meets the bar: that is the measurement.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

import chip_smoke as cs

ROOT = Path(__file__).resolve().parent
SOURCE = ROOT / "fp8_mode_probe.cu"
#: The sampler's bar over float32 coefficients (chip_smoke's spectral phase).
BAR = 1e-5
#: The fp8 cases: matmul_dtype name -> the kernel's case code.
CASES = {"float8_e4m3fn": 4, "float8_e5m2": 5}
#: Bytes of one probe tile: 80 latitude columns x (32 k + 16 pad).
ROW = 48
#: csrc/spectral.cu's tensor-core formats, and the probe's copy's.
MODE_ENUM = "enum class Mode { kBf16, kTf32x3, kF64, kF16 };"
MODE_ENUM_FP8 = ("enum class Mode { kBf16, kTf32x3, kF64, kF16, kFp8E4M3, "
                 "kFp8E5M2 };")


def build() -> Path:
    """Compile the probe into its own library (once per source hash)."""
    from rwrt_tpu_torch.kernels import build as kb

    digest = hashlib.sha256(" ".join(kb.NVCC_FLAGS).encode())
    for path in [SOURCE, *sorted(kb.CSRC.glob("*.cu*"))]:
        digest.update(path.name.encode() + path.read_bytes())
    out = kb.BUILD_ROOT / "fp8_probe" / digest.hexdigest()[:16]
    lib = out / "libfp8probe.so"
    if not lib.is_file():
        out.mkdir(parents=True, exist_ok=True)
        text = (kb.CSRC / "spectral.cu").read_text()
        if text.count(MODE_ENUM) != 1:
            raise RuntimeError("csrc/spectral.cu's Mode is not "
                               f"{MODE_ENUM!r}: update the probe")
        (out / "spectral_fp8.cu").write_text(
            text.replace(MODE_ENUM, MODE_ENUM_FP8))
        cmd = [kb.find_nvcc(), *kb.NVCC_FLAGS, "-shared", "-I", str(out),
               "-I", str(kb.CSRC), "-o", str(lib), str(SOURCE)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        (out / "nvcc.log").write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed:\n{' '.join(cmd)}\n"
                               f"{proc.stdout}\n{proc.stderr}")
    return lib


def core_tiles(torch, spec, coeffs, mm):
    """``pack_coeffs``' tiles of ``mm`` as the probe's: each (80, 32) block
    as float8 bytes in [n / 8][k / 16][n % 8][k % 16] order, then zeros to
    80 x ROW bytes."""
    t = spec.pack_coeffs(coeffs, mm)[..., :spec.KC].to(mm).view(torch.uint8)
    c, g, nkc, p, group, kc = t.shape
    core = t.reshape(c, g, nkc, p, group // 8, 8, kc // 16, 16)
    core = core.transpose(5, 6).reshape(c, g, nkc, p, group * kc)
    out = torch.zeros((c, g, nkc, p, group * ROW), dtype=torch.uint8,
                      device=coeffs.device)
    out[..., :group * kc] = core
    return out.contiguous()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", type=Path,
                    default=ROOT / "rwrt_tpu_torch" / "_build" / "fp8_probe")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("fp8_mode_probe: no CUDA device", file=sys.stderr)
        return 1
    import rwrt_tpu_torch as rt
    from rwrt_tpu_torch.ops import spectral_sample as spec

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    lib = ctypes.CDLL(str(build()))
    fn = lib.fp8_probe_spectral
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int

    run = cs.Run(torch, rt)
    traj = rt.trace_rays(run.bs(torch.float32), cs.production_config(rt),
                         source_lon=run.slon, source_lat=run.slat)
    lon10, lat10 = traj.lon[120].reshape(-1), traj.lat[120].reshape(-1)
    fin = torch.isfinite(lon10) & torch.isfinite(lat10)
    lo = torch.cat([lon10[fin], torch.tensor([0.3, float("nan"), 1.0],
                                             device=run.dev)]).contiguous()
    la = torch.cat([lat10[fin], torch.tensor([2.0, 0.1, -1.7],
                                             device=run.dev)]).contiguous()
    del traj
    sbg = spec.fit_spectral(run.bs(torch.float32))
    tht = (la - sbg.lat0).contiguous()
    mp, nl, nc = sbg.coeffs.shape
    kp, lp = spec.packed_dims(mp, nl)
    stream = torch.cuda.current_stream().cuda_stream
    rows = []
    for name, code in CASES.items():
        mm = getattr(torch, name)
        tiles = core_tiles(torch, spec, sbg.coeffs, mm)
        p = spec.sample_spectral(sbg, lo, la, matmul_dtype=mm)

        def fp8(out):
            err = fn(lo.data_ptr(), la.data_ptr(), tht.data_ptr(),
                     tiles.data_ptr(), lo.shape[0], mp, nl, nc, kp, lp, code,
                     out.data_ptr(), stream)
            if err != 0:
                raise RuntimeError(f"fp8_probe_spectral: CUDA error {err}")

        outs = [torch.empty_like(p), torch.empty_like(p)]
        for out in outs:
            fp8(out)
        torch.cuda.synchronize()
        cs.check(cs.same(outs[0], outs[1]), f"{name}: two launches differ")
        err = cs.spectral_err(outs[0], p)
        packed = spec.pack_on_card(sbg.coeffs, mm)
        pkg_out = torch.empty_like(p)

        def package():
            spec.launch_kernel(packed, lo, la, tht, sbg.coeffs.shape, mm,
                               pkg_out)

        turns = {"package": [], "fp8": []}
        for who in ("package", "fp8", "fp8", "package"):
            turns[who].append(cs.cuda_ms(
                package if who == "package" else lambda: fp8(outs[0]),
                args.reps))
        rec = dict(case=f"float32_{name}", lanes=lo.shape[0],
                   max_err_over_channel_max=err, bar=BAR,
                   meets_bar=err <= BAR,
                   nonfinite=int((~torch.isfinite(outs[0])).sum()),
                   fp8_kernel_ms=turns["fp8"],
                   package_bf16_kernel_ms=turns["package"],
                   package_err=cs.spectral_err(pkg_out, p))
        print(json.dumps(rec), flush=True)
        rows.append(rec)
    args.out.mkdir(parents=True, exist_ok=True)
    with open(args.out / "fp8_probe.jsonl", "a") as fh:
        for rec in rows:
            fh.write(json.dumps(rec) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
