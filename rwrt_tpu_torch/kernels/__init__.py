"""Launch plumbing shared by the kernel wrappers.

The wrappers live in the modules that own their ops (``models/ray.py``,
``solvers/rk45.py``, ``ops/spectral_sample.py``); this package builds and
loads the library (``build.py``), checks tensors, turns a nonzero
``cudaError_t`` into an exception, and chooses the integrator kernels'
instance for a launch (``choose_instance``).
"""

from __future__ import annotations

import functools

import torch

#: The C entry points' suffix by (state dtype, field dtype): one type, or
#: mixed precision, a float64 state over float32 fields (``build.MIXED``
#: names the entry points that have it).
_SUFFIX = {(torch.float32, torch.float32): "_f32",
           (torch.float64, torch.float64): "_f64",
           (torch.float64, torch.float32): "_mix"}

#: How the RK4 and exact kernels spread a lane's evaluation over threads
#: (``csrc/ray_rhs.cuh``), by the id their C entry points take: one thread
#: per lane (``lane``), or a team of 8 threads per lane that shares the
#: row's loads and lerps and its IEEE divisions (``split8``).
INSTANCES = {"lane": 0, "split8": 8}

#: The team instance the launcher takes, and the lane counts (least, most)
#: at which it does: measured on an NVIDIA H100 by ``profile_instances.py``
#: (PERF.md section 6), for the RK4 and exact kernels in both dtypes.
TEAM = "split8"
TEAM_LANES = (32, 6144)
#: The team's lane counts for the RK4 kernel's whole run, by variant (""
#: static, "_time" a time-varying or ensemble background), within what the
#: card keeps resident of the team (``choose_instance``). Measured on an
#: NVIDIA H100 by ``profile_main_path.py --rk4`` in float32, float64 and
#: mixed precision alike (PERF.md section 6): static, the team faster at
#: the default run's 4,288 lanes and the production seeding's first 2,048,
#: 6,144 and 8,192, Lane at 16,384; over frames, the team faster at the
#: default run's 4,288 lanes and two members' first 6,144; at their 8,864
#: Lane faster in float32 and even in mixed (float64's team, in two waves,
#: ran faster there, but does not fit the card at once, so the resident
#: cap takes Lane all the same).
RK4_TEAM_LANES = {"": (32, 8192), "_time": (32, 6144)}
#: The team's lane counts for the RHS kernel (``ray.rhs``) and the one-step
#: RK4 kernel (``solvers.rk4.rk4_step_rays``, the ``--report-exact`` RK4
#: re-run), by variant, within what the card keeps resident of the team.
#: One evaluation (or one step) a lane: the launch lasts its lanes' chain
#: until they fill the card, so the team, whose divisions wait three times
#: an evaluation where Lane's wait fourteen, holds until its threads
#: crowd the card. Swept on an NVIDIA H100 by ``chip_smoke.py``'s rhs
#: and time_rhs phases (``RHS_SWEEP``; PERF.md section 6): the RHS team
#: no slower than Lane to 16,384 lanes in float32 and float64, slower at
#: 32,768; the step's team to 8,192 (at 16,384 4 % slower in float64).
RHS_TEAM_LANES = {"": (1, 16384), "_time": (1, 16384)}
RK4_STEP_TEAM_LANES = {"": (1, 8192), "_time": (1, 8192)}
#: The team's lane counts for the exact kernel's whole run with a float64
#: state, by (state, field) dtypes: that kernel repacks its live lanes on a
#: persistent grid and queues the lanes beyond its slots, so no lane waits
#: for a second wave and the resident count caps nothing. Measured on an
#: NVIDIA H100 by ``profile_main_path.py --exact`` (PERF.md section 6):
#: the team no slower than Lane at every lane count measured up to the
#: window's most (4,288 README lanes; the production seeding's first
#: 8,192; float64's 8,864 lanes of two time-varying members), slower at
#: 16,384 and beyond.
REPACKED_TEAM_LANES = {(torch.float64, torch.float32): (32, 8192),
                       (torch.float64, torch.float64): (32, 8864)}


@functools.cache
def library():
    """The loaded kernel library, built from ``csrc/`` at first use."""
    from rwrt_tpu_torch.kernels import build

    return build.load()


def choose_instance(r: int, team_resident=None, lanes=TEAM_LANES) -> str:
    """The instance a launch of ``r`` lanes takes: the team ``TEAM`` where
    ``lanes`` (least, most; ``TEAM_LANES`` unless given) holds r (the lane
    counts at which the team was measured faster: it lengthens a lone
    lane's chain and multiplies the card's work by 8) and r * 8 threads
    fit in what the card keeps resident of the team at once
    (``team_resident`` threads), so that no lane waits for a second wave;
    ``team_resident`` None (a launch that queues its lanes) caps nothing.
    Else one thread per lane."""
    top = lanes[1] if team_resident is None else min(lanes[1],
                                                     team_resident // 8)
    if lanes[0] <= r <= top:
        return TEAM
    return "lane"


def instance_id(name: str) -> int:
    """The C id of instance ``name``; raises on an unknown one."""
    if name not in INSTANCES:
        raise ValueError(f"unknown kernel instance {name!r}; one of "
                         f"{sorted(INSTANCES)}")
    return INSTANCES[name]


def dtype_key(dtype) -> tuple:
    """The (state, field) dtypes of a launch: a torch dtype stands for
    itself twice; a pair is returned as it is."""
    if isinstance(dtype, (tuple, list)):
        return tuple(dtype)
    return dtype, dtype


def state_key(y: torch.Tensor, fields: torch.Tensor) -> tuple:
    """The (state, field) dtype pair of a launch over state ``y`` and
    background ``fields``; raises unless a kernel instance takes it."""
    key = (y.dtype, fields.dtype)
    if key not in _SUFFIX:
        raise ValueError(f"the kernels take a state of the background's "
                         f"dtype or a float64 state over float32 fields, "
                         f"not a {y.dtype} state over {fields.dtype}")
    return key


def resident(kernel: str, instance: str, dtype, *args,
             variant: str = "") -> int:
    """Threads of ``instance`` of ``rwrt_<kernel>`` (in ``dtype``, a torch
    dtype or a (state, field) pair; ``variant`` "" or "_time", the time
    instance) that the current card keeps resident at once, from the CUDA
    occupancy calculator (``rwrt_<kernel>_resident<variant>``, which takes
    ``args`` first): read once per process and card."""
    return _resident(torch.cuda.current_device(), kernel, instance,
                     dtype_key(dtype), *args, variant=variant)


@functools.cache
def _resident(card: int, kernel: str, instance: str, dtype, *args,
              variant: str = "") -> int:
    """``resident`` on card index ``card``, the current one."""
    out = torch.zeros(1, dtype=torch.int32)
    launch(f"rwrt_{kernel}_resident{variant}", dtype, *args,
           instance_id(instance), out)
    return int(out[0])


def check_tensor(t: torch.Tensor, name: str, *, device, dtype,
                 shape=None) -> None:
    """Raise unless ``t`` is a contiguous tensor of this device, dtype and
    (optionally) shape."""
    if not torch.is_tensor(t):
        raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_aligned(t: torch.Tensor, name: str, nbytes: int = 16) -> None:
    """Raise unless ``t``'s data starts on an ``nbytes`` boundary (the
    kernels read the background stack by 16-byte loads)."""
    if t.data_ptr() % nbytes:
        raise ValueError(f"{name} must start on a {nbytes}-byte boundary")


def stream(device) -> int:
    """The raw handle of PyTorch's current stream on ``device``."""
    return torch.cuda.current_stream(device).cuda_stream


def launch(name: str, dtype, *args) -> None:
    """Call ``<name>_f32``, ``<name>_f64`` or, for a (float64 state,
    float32 field) ``dtype`` pair, ``<name>_mix``; tensors pass as pointers
    and None as NULL. Raises if the launch returned a CUDA error.

    A kernel's outputs carry no autograd graph, so a launch refuses a
    tensor argument that requires grad while grad mode is on (before the
    library is loaded), rather than detach it silently."""
    from rwrt_tpu_torch.kernels import build

    if torch.is_grad_enabled() and any(
            torch.is_tensor(a) and a.requires_grad for a in args):
        raise RuntimeError(
            f"{name}: a hand-written kernel cannot carry gradients, and an "
            "input requires grad. Take the plain, differentiable route "
            "(solvers.rk4.trace over models.ray._rhs_core, on any device, "
            "or the CPU), or detach the input / run under torch.no_grad()")
    suffix = _SUFFIX.get(dtype_key(dtype))
    if suffix is None or (suffix == "_mix" and name not in build.MIXED):
        raise ValueError(f"{name} has no instance for dtype {dtype}")
    lib = library()
    fn = getattr(lib, name + suffix)
    c_args = [a.data_ptr() if torch.is_tensor(a) else a for a in args]
    code = fn(*c_args)
    if code != 0:
        msg = lib.rwrt_error_string(code).decode()
        raise RuntimeError(f"{name}{suffix} failed: CUDA error "
                           f"{code} ({msg})")
