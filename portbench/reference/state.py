"""The basic state, from the equations: the winds' finite differences on the
global (lon, lat) grid, absolute vorticity q and its derivatives, the
Mercator beta and the stationary wavenumber.

Grid: nlon equal steps of 2 pi / nlon from lon 0, nlat points pole to pole.
Differences are centred; lon is periodic; in lat a first derivative is
one-sided on the edge rows and a second or mixed one copies its nearest
interior row. q's second derivatives qxx, qxy and qyy are smoothed by the
9-point smoother (centre -(p + q), edges p / 4, corners q / 4 with p = 0.5,
q = 0.25) on rows and columns 1 .. n - 3 only; the third derivatives and
qyx are taken from the unsmoothed ones.

    q    = (v_x - (u cos phi)_y) / cos phi + 2 Omega R sin phi, pole rows
           copied from their neighbours
    bM   = (2 Omega cos^2 phi - (cos phi u_yy - sin phi u_y - u / cos phi)
           / R) / R, NaN on the pole rows
    Ks   = R sqrt(bM cos phi / u) where bM > 0 and u > 0, else NaN

Every operation runs in the dtype asked for (float64 for the reference,
lower for the control), on any device.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

OMEGA = 7.2921e-5
REARTH = 6.3712e6

#: The stacked fields, in the program's order.
NAMES = ("u", "v", "ux", "uy", "vx", "vy", "qx", "qy", "qxx", "qxy", "qyx",
         "qyy", "qxxx", "qxxy", "qxyy", "qyyy", "qyxx", "qyyx")


class State(NamedTuple):
    """fields (..., nlon + 1, nlat, 18), the lon wrap column appended;
    betam, ks, q (..., nlon, nlat); a leading frame axis where the winds
    have one."""

    fields: torch.Tensor
    betam: torch.Tensor
    ks: torch.Tensor
    q: torch.Tensor


def d_lon(f, d):
    return (f.roll(-1, -2) - f.roll(1, -2)) / (2 * d)


def d_lon2(f, d):
    return (f.roll(-1, -2) + f.roll(1, -2) - 2 * f) / (d * d)


def _edges(inner):
    """Rows 1 .. n - 2 given; rows 0 and n - 1 copied from them."""
    return torch.cat([inner[..., :1], inner, inner[..., -1:]], -1)


def d_lat(f, d):
    inner = (f[..., 2:] - f[..., :-2]) / (2 * d)
    lo = (f[..., 1:2] - f[..., :1]) / d
    hi = (f[..., -1:] - f[..., -2:-1]) / d
    return torch.cat([lo, inner, hi], -1)


def d_lat2(f, d):
    return _edges((f[..., 2:] + f[..., :-2] - 2 * f[..., 1:-1]) / (d * d))


def d_lonlat(f, dx, dy):
    g = f.roll(-1, -2) - f.roll(1, -2)
    return _edges((g[..., 2:] - g[..., :-2]) / (4 * dx * dy))


def smooth9(f, p=0.5, q=0.25):
    """The 9-point smoother on rows and columns 1 .. n - 3 of the last two
    axes; the rest kept."""
    c = f[..., 1:-2, 1:-2]
    cross = (f[..., :-3, 1:-2] + f[..., 2:-1, 1:-2] + f[..., 1:-2, :-3]
             + f[..., 1:-2, 2:-1])
    corner = (f[..., :-3, :-3] + f[..., :-3, 2:-1] + f[..., 2:-1, :-3]
              + f[..., 2:-1, 2:-1])
    out = f.clone()
    out[..., 1:-2, 1:-2] = c + (p / 4 * cross + q / 4 * corner - (p + q) * c)
    return out


def prepare(u, v, dtype, device) -> State:
    """The basic state of winds u, v ((..., nlon, nlat) host arrays of the
    values as read) in ``dtype`` on ``device``."""
    u = torch.tensor(np.asarray(u)).to(device=device, dtype=dtype)
    v = torch.tensor(np.asarray(v)).to(device=device, dtype=dtype)
    nlon, nlat = u.shape[-2:]
    dx = 2 * math.pi / nlon
    dy = math.pi / (nlat - 1)
    lat = (torch.arange(nlat, dtype=torch.float64) * dy - math.pi / 2).to(
        device=device, dtype=dtype)
    cos, sin = torch.cos(lat), torch.sin(lat)
    uy, vx = d_lat(u, dy), d_lon(v, dx)
    q = _edges(((vx - d_lat(u * cos, dy)) / cos
                + 2 * OMEGA * REARTH * sin)[..., 1:-1])
    qxx, qyy, qxy = d_lon2(q, dx), d_lat2(q, dy), d_lonlat(q, dx, dy)
    stack = [u, v, d_lon(u, dx), uy, vx, d_lat(v, dy), d_lon(q, dx),
             d_lat(q, dy), smooth9(qxx), smooth9(qxy), qxy, smooth9(qyy),
             d_lon(qxx, dx), d_lat(qxx, dy), d_lat(qxy, dy), d_lat(qyy, dy),
             d_lon(qxy, dx), d_lon(qyy, dx)]
    fields = torch.stack(stack, -1)
    fields = torch.cat([fields, fields[..., :1, :, :]], -3)
    nan = torch.full_like(u, math.nan)
    inner = slice(1, nlat - 1)
    bm = (2 * OMEGA * cos ** 2
          - (cos * d_lat2(u, dy) - sin * uy - u / cos) / REARTH) / REARTH
    betam = nan.clone()
    betam[..., inner] = bm[..., inner]
    ok = (betam > 0) & (u > 0)
    ks = torch.where(ok, REARTH * torch.sqrt(
        torch.where(ok, betam * cos / u, torch.ones_like(u))), nan)
    return State(fields, betam, ks, q)
