"""Host-side polynomial root backends (port of ``rwrt_tpu/ops/cubic_host.py``).

The device path never calls these -- it uses the closed-form solve in
``ops/cubic.py`` -- except ``initial_roots_reference_order``, which
``tracer.initialize`` runs once on the host for root_order='fortran':

- ``roots_native``: the C++ Aberth-Ehrlich solver (``rwrt_tpu_torch/native/``),
  built and loaded lazily; when it cannot be built it degrades to numpy
  with a one-time warning.
- ``roots_numpy``: np.roots per row.
- ``initial_roots_reference_order``: the reference's exact initial slot
  layout, np.roots plus the Fortran-heritage slot shuffle.
"""

from __future__ import annotations

import ctypes
import warnings

import numpy as np
import torch

from rwrt_tpu_torch.native import build as _native_build

_warned = False


def roots_numpy(coeffs: np.ndarray) -> np.ndarray:
    """np.roots per row. coeffs: (batch, degree+1) highest-first -> complex
    roots (batch, degree) (rows with ~zero leading coeff get NaN padding)."""
    coeffs = np.atleast_2d(coeffs)
    batch, ncoef = coeffs.shape
    degree = ncoef - 1
    out = np.full((batch, degree), np.nan + 0j, dtype=np.complex128)
    for i in range(batch):
        r = np.roots(coeffs[i])
        out[i, : len(r)] = r
    return out


def roots_native(coeffs: np.ndarray, max_iter: int = 200,
                 tol: float = 1e-14) -> np.ndarray:
    """C++ batched Aberth-Ehrlich roots; falls back to numpy if the native
    library is unavailable."""
    global _warned
    lib = _native_build.load()
    coeffs = np.ascontiguousarray(np.atleast_2d(coeffs), dtype=np.complex128)
    if lib is None:
        if not _warned:
            warnings.warn(
                "native cpolyroots unavailable; falling back to numpy.roots"
            )
            _warned = True
        return roots_numpy(coeffs)

    batch, ncoef = coeffs.shape
    degree = ncoef - 1
    cre = np.ascontiguousarray(coeffs.real)
    cim = np.ascontiguousarray(coeffs.imag)
    rre = np.empty((batch, degree), dtype=np.float64)
    rim = np.empty((batch, degree), dtype=np.float64)
    dp = ctypes.POINTER(ctypes.c_double)
    lib.cpoly_roots_batch(
        batch, degree,
        cre.ctypes.data_as(dp), cim.ctypes.data_as(dp),
        rre.ctypes.data_as(dp), rim.ctypes.data_as(dp),
        max_iter, tol,
    )
    return rre + 1j * rim


def solve_roots(coeffs: np.ndarray, backend: str = "native") -> np.ndarray:
    """Backend dispatch: 'native' or 'numpy'."""
    if backend == "native":
        return roots_native(coeffs)
    if backend == "numpy":
        return roots_numpy(coeffs)
    raise ValueError(f"unknown backend {backend!r}")


def initial_roots_reference_order(fmu, fmv, fmqx, fmqy, freq, zwn):
    """Initial meridional-wavenumber roots in the reference's exact slot
    layout (``RunConfig.root_order == 'fortran'``).

    np.roots on each (source, zwn) cubic, then the Fortran-heritage slot
    shuffle (``ops.cubic.fortran_slot_order``): the layout depends on the
    eigenvalue order LAPACK emits inside np.roots (the shuffle is NOT
    permutation-invariant), so it can only be reproduced by calling np.roots
    itself, on the very float64 coefficients the JAX package builds. This
    runs once on the host at initialization; the device path is untouched.

    Args:
      fmu, fmv, fmqx, fmqy: (nsource,) Mercator background at the sources
        (numpy or tensors on any device; widened to float64).
      freq: scalar wave frequency (rad/s).
      zwn: (nzwn,) initial zonal wavenumbers.

    Returns:
      (nsource, nzwn, 3) float64 numpy roots, NaN-padded, reference slot
      order.
    """
    from rwrt_tpu_torch.constants import delt, rearth
    from rwrt_tpu_torch.convert import host
    from rwrt_tpu_torch.ops.cubic import fortran_slot_order

    fmu, fmv, fmqx, fmqy, zwn = (host(x, np.float64)
                                 for x in (fmu, fmv, fmqx, fmqy, zwn))
    ns, nz = fmu.shape[0], zwn.shape[0]
    raw = np.full((ns, nz, 3), np.nan)   # np.roots emission order
    counts = np.zeros((ns, nz), np.int32)
    for zi, k in enumerate(zwn):
        if k == 0.0:
            continue
        ps = freq / k * rearth
        # LOWEST-degree-first coefficient stack [c0, c1, c2, c3] with
        # c3 = fmv the m^3 term: the trailing-entry degree reduction below
        # strips leading (highest-degree) coefficients, and the [::-1]
        # before np.roots flips to the highest-first order np.roots expects.
        coeff_ = np.stack([
            (k ** 3) * (fmu - ps - fmqy / k ** 2),
            (k ** 2) * fmv + fmqx,
            k * (fmu - ps),
            fmv,
        ], axis=-1)
        for si in range(ns):
            coeff = coeff_[si]
            # Exact-zero trailing-entry reduction (the reference's numpy
            # dialect tests == 0, not < delt).
            deg = 3
            while deg > 0 and abs(coeff[deg]) == 0:
                deg -= 1
            if deg < 1 or np.any(~np.isfinite(coeff[: deg + 1])):
                continue
            r = np.roots(coeff[: deg + 1][::-1].astype(np.complex128))
            real = [x.real for x in r if abs(x.imag) < delt]
            raw[si, zi, : min(len(real), 3)] = real[:3]
            counts[si, zi] = len(real)
    # The |m| > 100 NaN filter runs AFTER the swaps, as in the reference
    # (elementwise, so after the reversal too).
    out = fortran_slot_order(torch.from_numpy(raw),
                             torch.from_numpy(counts)).numpy()
    return np.where(np.abs(out) > 100.0, np.nan, out)
