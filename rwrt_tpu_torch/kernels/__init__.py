"""Launch plumbing shared by the kernel wrappers.

The wrappers live in the modules that own their ops (``models/ray.py``,
``solvers/rk45.py``, ``ops/spectral_sample.py``); this package only builds
and loads the library (``build.py``), checks tensors and turns a nonzero
``cudaError_t`` into an exception.
"""

from __future__ import annotations

import functools

import torch

_SUFFIX = {torch.float32: "_f32", torch.float64: "_f64"}


@functools.cache
def library():
    """The loaded kernel library, built from ``csrc/`` at first use."""
    from rwrt_tpu_torch.kernels import build

    return build.load()


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


def launch(name: str, dtype: torch.dtype, *args) -> None:
    """Call ``<name>_f32`` or ``<name>_f64``; tensors pass as pointers and
    None as NULL. Raises if the launch returned a CUDA error."""
    if dtype not in _SUFFIX:
        raise ValueError(f"the kernels take float32 or float64, not {dtype}")
    lib = library()
    fn = getattr(lib, name + _SUFFIX[dtype])
    c_args = [a.data_ptr() if torch.is_tensor(a) else a for a in args]
    code = fn(*c_args)
    if code != 0:
        msg = lib.rwrt_error_string(code).decode()
        raise RuntimeError(f"{name}{_SUFFIX[dtype]} failed: CUDA error "
                           f"{code} ({msg})")
