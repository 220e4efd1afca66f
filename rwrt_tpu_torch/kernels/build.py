"""Build the port's CUDA kernels at first use and load them with ctypes.

One ``nvcc`` per ``rwrt_tpu_torch/csrc/*.cu``, all started together,
compiles a relocatable object each; one more links them (device code
included) into a shared library with a plain C interface (no PyTorch
headers, so a build takes seconds), in
``rwrt_tpu_torch/_build/<hash of the sources>/``, beside ``nvcc.log`` (the
compiler's ``-Xptxas -v`` report: registers, shared memory, spills per
kernel). The hash covers the sources, the headers and the flags, so an
edited source rebuilds and an unchanged one loads the library already
built. Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC = PKG_DIR / "csrc"
BUILD_ROOT = PKG_DIR / "_build"
LIB_NAME = "librwrt_kernels.so"

# -fmad=false: no implicit a*b+c -> fma contraction, so every kernel
# expression rounds exactly as the plain PyTorch version's separate ops do
# and the kernels are bit-comparable to it (the adaptive controller
# amplifies one-ulp differences chaotically). Explicit fma() calls, as in
# the spectral contraction, are unaffected.
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-fmad=false", "-Xcompiler",
              "-fPIC", "-Xptxas=-v")
#: The units built WITH contraction (``-fmad=true``): libdevice's float64
#: pow as PyTorch's own build rounds it, which the plain versions' ``**``
#: runs (csrc/pow_fmad.cu says why).
CONTRACTED = ("pow_fmad.cu",)
#: The units built as relocatable device code (``-rdc=true``): those whose
#: kernels carry a float64 step controller and so call ``CONTRACTED``'s pow
#: across units, and that unit. The others stay whole-program units: -rdc
#: costs the float32 kernels registers and 2-35 % of their time (measured
#: on an H100 when every unit was relocatable), since calls into the math
#: library's slow paths then take the standard calling convention.
RELOCATABLE = ("dense_run_f64.cu", "dense_run_mix.cu", "exact_run_f64.cu",
               "exact_run_mix.cu", "dense_run_time_f64.cu",
               "dense_run_time_mix.cu", "exact_run_time_f64.cu",
               "exact_run_time_mix.cu", "interval_f64.cu", "entry_f64.cu",
               "entry_time_f64.cu", *CONTRACTED)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_D = ctypes.c_double

#: C signature of every exported function; each returns a cudaError_t.
SIGNATURES = {
    # packed, W, H, lon0, lat0, dx, dy, y, R, dy_out, err, ug, vg, stream
    "rwrt_rhs": (_P, _I, _I, _D, _D, _D, _D, _P, _I, _P, _P, _P, _P, _P),
    # packed, W, H, lon0, lat0, dx, dy, y, R, rtol, atol, f0, h, stream
    "rwrt_entry": (_P, _I, _I, _D, _D, _D, _D, _P, _I, _D, _D, _P, _P, _P),
    # packed, W, H, lon0, lat0, dx, dy, y, t, h, f, rejected, new_step,
    # lane_att, hist, bounds, G, R, rtol, atol, min_step, max_iters,
    # pin_limit, pin_mwn, stream
    "rwrt_dense_group": (_P, _I, _I, _D, _D, _D, _D, _P, _P, _P, _P, _P, _P,
                         _P, _P, _P, _I, _I, _D, _D, _D, _L, _L, _D, _P),
    # packed, W, H, lon0, lat0, dx, dy, y, t, h, f, ug0, vg0, hist, ugs,
    # vgs, lane_att, trunc, plon, plat, bounds, G, n_groups, R, cut_off,
    # rtol, atol, min_step, max_iters, pin_limit, pin_mwn, blocks, queue,
    # every, trigger, stream
    "rwrt_dense_run": (_P, _I, _I, _D, _D, _D, _D, _P, _P, _P, _P, _P, _P,
                       _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _D, _D,
                       _D, _D, _L, _L, _D, _I, _P, _I, _I, _P),
    # out (int32 on the host): resident blocks of the whole run, threads a
    # block
    "rwrt_dense_resident": (_P,),
    # packed, W, H, lon0, lat0, dx, dy, y, ug0, vg0, ys, ugs, vgs, n_steps,
    # row_offset, R, dt, half, sixth, cut_off, instance, stream
    "rwrt_rk4_run": (_P, _I, _I, _D, _D, _D, _D, _P, _P, _P, _P, _P, _P, _I,
                     _I, _I, _D, _D, _D, _D, _I, _P),
    # instance, out (int32 on the host): threads the card keeps resident
    "rwrt_rk4_resident": (_I, _P),
    # packed, W, H, lon0, lat0, dx, dy, y, t, h, f, plon, plat, rejected,
    # new_step, lane_att, idx, trips, hist, bounds, G, R, resume, cut_off,
    # rtol, atol, min_step, max_iters, instance, stream
    "rwrt_exact_group": (_P, _I, _I, _D, _D, _D, _D, _P, _P, _P, _P, _P, _P,
                         _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _D, _D, _D,
                         _D, _L, _I, _P),
    # packed, W, H, lon0, lat0, dx, dy, y, t, h, f, plon, plat, ug0, vg0,
    # hist, ugs, vgs, lane_att, trunc, bounds, G, n_groups, R, cut_off, rtol,
    # atol, min_step, max_iters, barrier, instance, stream
    "rwrt_exact_run": (_P, _I, _I, _D, _D, _D, _D, _P, _P, _P, _P, _P, _P, _P,
                       _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _D, _D, _D, _D,
                       _L, _I, _I, _P),
    # run (1: the whole-run kernel, 0: the single group), instance, out
    "rwrt_exact_resident": (_I, _I, _P),
    # packed, W, H, lon0, lat0, dx, dy, y, t, h, t_bound, trips, R, rtol,
    # atol, min_step, max_iters, instance, stream
    "rwrt_interval": (_P, _I, _I, _D, _D, _D, _D, _P, _P, _P, _P, _P, _I, _D,
                      _D, _D, _L, _I, _P),
    # instance, out (int32 on the host): threads the card keeps resident
    "rwrt_interval_resident": (_I, _P),
    # lon, lat, tht, packed, R, Mp, L, C, Kp, Lp, operand case, out, stream
    "rwrt_spectral": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P),
    # x, n, operand case, out, stream (the kernel's operand rounding alone)
    "rwrt_spectral_round": (_P, _L, _I, _P, _P),
    # lon, lat, amp, ug, vg, ky, their row strides, nt, R, keep, u_prev,
    # base_prev, carry_in, fu, fv, asum, cnt, nlon_bins, nlat_bins,
    # inv_dlon, inv_dlat, amp_min, amp_max, speed_min, speed_max, mwn_max,
    # checks, weight, rays, n_kept, ixs, acc, stream
    "rwrt_flux": (_P, _P, _P, _P, _P, _P, _L, _L, _L, _L, _L, _L, _I, _I, _P,
                  _P, _P, _I, _P, _P, _P, _P, _I, _I, _D, _D, _D, _D, _D, _D,
                  _D, _I, _I, _P, _P, _P, _P, _P),
    # lon, lat, amp, their row strides, nt, R, mode, lo0, lo1, la0, la1,
    # keep, stream
    "rwrt_flux_region": (_P, _P, _P, _L, _L, _L, _I, _I, _I, _D, _D, _D, _D,
                         _P, _P),
    # table, width, idx, R, out, stream
    "rwrt_gather": (_P, _I, _P, _I, _P, _P),
}

#: The time instances' entry points (``<name>_time``: a time-varying or
#: ensemble background, ``models.ray.kernel_background``): the static
#: signature with the background's nt, timed, t0, dt and member map after
#: the grid (packed, W, H, lon0, lat0, dx, dy); the RHS's and the entry
#: stage's take the lanes' times (a pointer) after y, the RK4 run the
#: carry's time after cut_off.
_VAR = (_I, _I, _D, _D, _P)


def _time_signature(name: str) -> tuple:
    sig = SIGNATURES[name]
    sig = sig[:7] + _VAR + sig[7:]
    if name in ("rwrt_rhs", "rwrt_entry"):
        sig = sig[:13] + (_P,) + sig[13:]
    if name == "rwrt_rk4_run":
        sig = sig[:-2] + (_D,) + sig[-2:]
    return sig


for _name in ("rwrt_rhs", "rwrt_entry", "rwrt_rk4_run", "rwrt_exact_run",
              "rwrt_dense_run", "rwrt_exact_group", "rwrt_dense_group",
              "rwrt_interval"):
    SIGNATURES[_name + "_time"] = _time_signature(_name)
# The occupancy counts of the time instances take the static ones' args.
SIGNATURES["rwrt_rk4_resident_time"] = SIGNATURES["rwrt_rk4_resident"]
SIGNATURES["rwrt_exact_resident_time"] = SIGNATURES["rwrt_exact_resident"]
SIGNATURES["rwrt_dense_resident_time"] = SIGNATURES["rwrt_dense_resident"]
SIGNATURES["rwrt_interval_resident_time"] = SIGNATURES[
    "rwrt_interval_resident"]


#: The entry points that also have a mixed-precision instance (``_mix``: a
#: float64 state over float32 fields): the integrator kernels, whole run
#: and single group, their occupancy counts, and the entry stage.
MIXED = ("rwrt_entry", "rwrt_entry_time", "rwrt_rk4_run",
         "rwrt_rk4_resident", "rwrt_exact_run",
         "rwrt_exact_group", "rwrt_exact_resident", "rwrt_dense_run",
         "rwrt_dense_group", "rwrt_rk4_run_time", "rwrt_rk4_resident_time",
         "rwrt_exact_run_time", "rwrt_exact_resident_time",
         "rwrt_dense_run_time", "rwrt_exact_group_time",
         "rwrt_dense_group_time", "rwrt_dense_resident",
         "rwrt_dense_resident_time")


def unit_flags(name: str) -> list:
    """The nvcc flags of the unit ``name``: ``NVCC_FLAGS``, with
    contraction for ``CONTRACTED`` and -rdc=true for ``RELOCATABLE``."""
    flags = [("-fmad=true" if f == "-fmad=false" and name in CONTRACTED
              else f) for f in NVCC_FLAGS]
    return flags + (["-rdc=true"] if name in RELOCATABLE else [])


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    cu, cuh = _sources()
    digest = hashlib.sha256(
        " ".join(NVCC_FLAGS + CONTRACTED + RELOCATABLE).encode())
    for path in cu + cuh:
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    return digest.hexdigest()[:16]


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda); "
                       "the port's CUDA kernels cannot be built")


def build() -> Path:
    """Compile the kernels if no library for these sources exists; returns
    the library's path. Raises on a failed build."""
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / LIB_NAME
    if lib.is_file():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp_dir:
        jobs, objs = [], []
        for src in _sources()[0]:
            objs.append(os.path.join(tmp_dir, src.stem + ".o"))
            cmd = [nvcc, *unit_flags(src.name), "-c", "-o", objs[-1],
                   str(src)]
            jobs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log = []
        for cmd, proc in jobs:
            log.append(f"$ {' '.join(cmd)}\n{proc.communicate()[0]}")
        (out_dir / "nvcc.log").write_text("\n".join(log))
        if any(proc.returncode != 0 for _, proc in jobs):
            raise RuntimeError("nvcc failed:\n" + "\n".join(log))
        tmp = os.path.join(tmp_dir, LIB_NAME)
        cmd = [nvcc, *ARCH, "-shared", "-rdc=true", "-o", tmp, *objs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stdout}\n"
                               f"{proc.stderr}")
        os.replace(tmp, lib)  # atomic: a concurrent loader never sees half
    return lib


def load() -> ctypes.CDLL:
    """Build (if needed) and load the library with every signature set."""
    lib = ctypes.CDLL(str(build()))
    for suffix in ("_f32", "_f64", "_mix"):
        for name, args in SIGNATURES.items():
            if suffix == "_mix" and name not in MIXED:
                continue
            fn = getattr(lib, name + suffix)
            fn.argtypes = list(args)
            fn.restype = ctypes.c_int
    lib.rwrt_error_string.argtypes = [ctypes.c_int]
    lib.rwrt_error_string.restype = ctypes.c_char_p
    return lib
