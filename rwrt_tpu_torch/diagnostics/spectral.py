"""Spherical-harmonic spectral filtering of background fields (SHSF).

Port of ``rwrt_tpu/diagnostics/spectral.py``: expand the gridded field in
spherical harmonics, triangular-truncate at Lmax and resynthesize -- the
smoothing of (u, v) that ``RunConfig.shsf_truncation`` applies at ingest.
Longitude is handled by a real FFT (``torch.fft.rfft``) and latitude by
dense per-wavenumber Legendre filter matrices, built on the host in numpy
(float64) and cached; the filter is the FFT, one batched product per real
and imaginary part, and the inverse FFT, on the field's device.

Two analysis modes:

- ``mode='projection'`` (default; any ascending latitude grid, including
  the pipeline's pole-to-pole grids): per zonal wavenumber m the
  least-squares projection of the FFT coefficients onto the normalized
  associated Legendre functions up to Lmax.
- ``mode='dh'`` (requires a Driscoll & Healy grid: N equally spaced
  colatitudes pi*j/N, j=0..N-1, N even -- north pole included, south pole
  excluded): exact DH quadrature analysis; coefficients of a field
  band-limited below N/2 are recovered exactly.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def normalized_legendre(x: np.ndarray, lmax: int, m: int) -> np.ndarray:
    """Normalized associated Legendre functions p̄_l^m(x), l = m..lmax.

    Normalization: integral over [-1, 1] of p̄_l^m p̄_l'^m dx = delta_ll'.
    Stable three-term recursion. Returns (len(x), lmax - m + 1).
    """
    x = np.asarray(x, np.float64)
    s = np.sqrt(np.maximum(0.0, 1.0 - x * x))
    # p̄_m^m
    pmm = np.full_like(x, np.sqrt(0.5))
    for k in range(1, m + 1):
        pmm = pmm * s * np.sqrt((2 * k + 1) / (2.0 * k))
    cols = [pmm]
    if lmax > m:
        cols.append(np.sqrt(2 * m + 3.0) * x * pmm)
    for l in range(m + 2, lmax + 1):
        a = np.sqrt((4.0 * l * l - 1.0) / (l * l - m * m))
        b = np.sqrt(((l - 1.0) ** 2 - m * m) / (4.0 * (l - 1.0) ** 2 - 1.0))
        cols.append(a * (x * cols[-1] - b * cols[-2]))
    return np.stack(cols, axis=-1)


@functools.lru_cache(maxsize=8)
def _filter_matrices(lat_key, lmax: int):
    """Per-m latitude filter matrices F_m = S_m @ pinv(S_m), stacked.

    lat_key: tuple of latitudes (radians). Returns (lmax + 1, nlat, nlat)
    float64 numpy array, where F_m projects a latitude profile onto the
    Legendre basis of degrees m..lmax.
    """
    lat = np.asarray(lat_key)
    x = np.sin(lat)
    mats = []
    for m in range(lmax + 1):
        s = normalized_legendre(x, lmax, m)  # (nlat, lmax-m+1)
        mats.append(s @ np.linalg.pinv(s, rcond=1e-10))
    return np.stack(mats)


def dh_weights(n: int) -> np.ndarray:
    """Driscoll & Healy (1994) quadrature weights for colatitudes
    theta_j = pi*j/n, j = 0..n-1 (n even)."""
    j = np.arange(n)
    theta = np.pi * j / n
    k = np.arange(n // 2)
    # w_j = (4/n) sin(theta_j) sum_k sin((2k+1) theta_j) / (2k+1)
    s = np.sin(np.outer(theta, 2 * k + 1)) / (2 * k + 1)
    return (4.0 / n) * np.sin(theta) * s.sum(axis=1)


def _is_dh_grid(lat: np.ndarray) -> bool:
    n = lat.shape[0]
    if n % 2:
        return False
    want = np.pi / 2 - np.pi * np.arange(n)[::-1] / n  # ascending
    # Absorb float32-stored coordinates (~1.2e-7 rad rounding near pi/2);
    # the nearest non-DH uniform grid differs by O(pi/n^2) >> 1e-6.
    return bool(np.allclose(lat, want, atol=1e-6))


@functools.lru_cache(maxsize=8)
def _dh_matrices(nlat: int, lmax: int):
    """Per-m DH filter matrices F_m = S_m @ (S_m^T W), stacked; latitudes
    in DH order ascending (south-most first, north pole last)."""
    theta = np.pi * np.arange(nlat) / nlat
    x = np.cos(theta)[::-1]  # ascending in latitude
    w = dh_weights(nlat)[::-1]
    mats = []
    for m in range(lmax + 1):
        s = normalized_legendre(x, lmax, m)  # (nlat, lmax-m+1)
        mats.append(s @ (s.T * w[None, :]))
    return np.stack(mats)


def spectral_filter(field, lat, lmax: int, mode: str = "projection", *,
                    device="cuda"):
    """Triangular-truncation spherical-harmonic filter.

    Args:
      field: (..., nlon, nlat) gridded data: a tensor, filtered on its own
        device, or an array, filtered on ``device``.
      lat: (nlat,) latitudes in radians, ascending.
      lmax: truncation degree (e.g. 180/dphi_deg - 1).
      mode: 'projection' (any grid) or 'dh' (exact Driscoll & Healy
        quadrature; requires the DH grid -- see module docstring).
      device: where an array ``field`` is filtered ("cuda" by default;
        "cpu" only on request). A tensor ``field`` ignores it.

    Returns:
      (..., nlon, nlat) filtered tensor, the field's dtype and device.
    """
    if not torch.is_tensor(field):
        field = torch.as_tensor(np.asarray(field), device=device)
    lat = lat.detach().cpu().numpy() if torch.is_tensor(lat) else lat
    lat = np.asarray(lat, np.float64)
    nlon, nlat = field.shape[-2:]
    m_count = min(lmax, nlon // 2) + 1

    if mode == "projection":
        mats = _filter_matrices(tuple(lat.tolist()), lmax)
    elif mode == "dh":
        if not _is_dh_grid(lat):
            raise ValueError(
                "mode='dh' needs the Driscoll & Healy grid: nlat even, "
                "colatitudes pi*j/nlat (north pole included, south pole "
                "excluded); use mode='projection' for other grids"
            )
        mats = _dh_matrices(nlat, lmax)
    else:
        raise ValueError(f"unknown mode {mode!r}")
    mats = torch.as_tensor(mats[:m_count]).to(device=field.device,
                                             dtype=field.dtype)

    fm = torch.fft.rfft(field, dim=-2)  # (..., nlon//2+1, nlat) complex
    keep = fm[..., :m_count, :]
    # The per-m latitude projection: (m, nlat, nlat) x (..., m, nlat).
    filt_re = torch.matmul(mats, keep.real[..., None])[..., 0]
    filt_im = torch.matmul(mats, keep.imag[..., None])[..., 0]
    out = torch.zeros_like(fm)
    out[..., :m_count, :] = torch.complex(filt_re, filt_im)
    return torch.fft.irfft(out, n=nlon, dim=-2).to(field.dtype)


def shsf(data, lat, truncation_level: int, mode: str = "projection", *,
         device="cuda"):
    """Filter one or more fields: data (nlon, nlat) or (k, nlon, nlat).
    mode='dh' reproduces the SHExpandDH -> truncate -> MakeGridDH pipeline
    on DH-sampled grids. An array ``data`` is filtered on ``device``."""
    return spectral_filter(data, lat, truncation_level, mode, device=device)
