"""Finite-difference grid operators on the (nlon, nlat) sphere grid.

Port of ``rwrt_tpu/ops/grid.py``: central differences with a periodic x
axis and one-sided or copied y edges, the NCL-style 9-point smoother with its
[1:-2, 1:-2] window, absolute vorticity, Mercator beta and the stationary
wavenumber. Every expression keeps the JAX operation order, so float64 results
agree to round-off.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from rwrt_tpu_torch.constants import omega, rearth, undef


def gradient_x(f: torch.Tensor, dx) -> torch.Tensor:
    """d f / d lambda with periodic wrap in the first (lon) axis."""
    fp = torch.roll(f, -1, dims=0)
    fm = torch.roll(f, 1, dims=0)
    return (fp - fm) / (2.0 * dx)


def gradient_y(f: torch.Tensor, dy) -> torch.Tensor:
    """d f / d phi; one-sided differences at the lat edges."""
    fy_mid = (f[:, 2:] - f[:, :-2]) / (2.0 * dy)
    fy_lo = (f[:, 1:2] - f[:, 0:1]) / dy
    fy_hi = (f[:, -1:] - f[:, -2:-1]) / dy
    return torch.cat([fy_lo, fy_mid, fy_hi], dim=1)


def gradient_xx(f: torch.Tensor, dx) -> torch.Tensor:
    """d^2 f / d lambda^2 with periodic wrap."""
    fp = torch.roll(f, -1, dims=0)
    fm = torch.roll(f, 1, dims=0)
    return (fp - 2.0 * f + fm) / (dx * dx)


def gradient_yy(f: torch.Tensor, dy) -> torch.Tensor:
    """d^2 f / d phi^2; edge rows copied from their neighbours."""
    fyy_mid = (f[:, 2:] - 2.0 * f[:, 1:-1] + f[:, :-2]) / (dy * dy)
    return torch.cat([fyy_mid[:, 0:1], fyy_mid, fyy_mid[:, -1:]], dim=1)


def gradient_xy(f: torch.Tensor, dx, dy) -> torch.Tensor:
    """Mixed derivative d^2 f / (d lambda d phi); x wraps, y edges copy."""
    fp = torch.roll(f, -1, dims=0)
    fm = torch.roll(f, 1, dims=0)
    mid = (fp[:, 2:] - fp[:, :-2] - fm[:, 2:] + fm[:, :-2]) / (4.0 * dx * dy)
    return torch.cat([mid[:, 0:1], mid, mid[:, -1:]], dim=1)


def smth9(f: torch.Tensor, p: float = 0.5, q: float = 0.25) -> torch.Tensor:
    """NCL-style 9-point smoother, added back only on the window [1:-2, 1:-2].

    The last interior row and column stay unsmoothed, a quirk of the Fortran
    loop bounds that the JAX package keeps and so does the port.
    """
    k_cross = p / 4.0
    k_corner = q / 4.0
    k_center = -(p + q)
    fpad = F.pad(f, (1, 1, 1, 1), mode="constant", value=0.0)
    n0, n1 = f.shape

    def sh(di, dj):
        return fpad[1 + di: 1 + di + n0, 1 + dj: 1 + dj + n1]

    corr = (
        k_center * f
        + k_cross * (sh(-1, 0) + sh(1, 0) + sh(0, -1) + sh(0, 1))
        + k_corner * (sh(-1, -1) + sh(-1, 1) + sh(1, -1) + sh(1, 1))
    )
    out = f.clone()
    out[1:-2, 1:-2] = f[1:-2, 1:-2] + corr[1:-2, 1:-2]
    return out


def absolute_vorticity(u, v, lat, dx, dy) -> torch.Tensor:
    """q = (v_x - (u cos phi)_y) / cos phi + 2 Omega sin(phi) R, pole rows
    copied from their neighbours (q carries a factor R on the planetary
    term)."""
    coslat = torch.cos(lat)[None, :]
    sinlat = torch.sin(lat)[None, :]
    u_cos_y = gradient_y(u * coslat, dy)
    v_x = gradient_x(v, dx)
    q_mid = (v_x - u_cos_y) / coslat + 2.0 * omega * sinlat * rearth
    q = q_mid[:, 1:-1]
    return torch.cat([q[:, 0:1], q, q[:, -1:]], dim=1)


def betam_field(u, uy, uyy, lat) -> torch.Tensor:
    """Meridional gradient of absolute vorticity on the Mercator projection;
    pole rows undef."""
    coslat = torch.cos(lat)[None, :]
    sinlat = torch.sin(lat)[None, :]
    bm = (
        2.0 * omega * coslat**2
        + (-coslat * uyy + sinlat * uy + u / coslat) / rearth
    ) / rearth
    edge = torch.full_like(bm[:, 0:1], undef)
    return torch.cat([edge, bm[:, 1:-1], edge], dim=1)


def stationary_wavenumber(betam, u, lat) -> torch.Tensor:
    """Ks = sqrt(beta_M cos(phi) / u) * R where beta_M > 0 and u > 0, else
    undef; pole rows undef."""
    coslat = torch.cos(lat)[None, :]
    valid = (betam > 0.0) & (u > 0.0)
    safe_u = torch.where(u == 0.0, torch.ones_like(u), u)
    # Double wheres: the invalid lanes' betam (undef at the pole rows) and
    # sqrt argument are finite substitutes, so their zero cotangent stays
    # zero in reverse mode (0 * NaN, 0 / sqrt(0)).
    one = torch.ones_like(u)
    safe_bm = torch.where(valid, betam, one)
    arg = torch.where(valid, safe_bm * coslat / safe_u, one)
    ks = torch.where(valid, torch.sqrt(arg) * rearth,
                     torch.full_like(arg, undef))
    edge = torch.full_like(ks[:, 0:1], undef)
    return torch.cat([edge, ks[:, 1:-1], edge], dim=1)
