"""The basic state: the background flow and its derivative stack.

Port of ``rwrt_tpu/models/basic_state.py`` (static backgrounds). ``prepare``
builds absolute vorticity and the 18-field derivative stack (u, v, ux, uy,
vx, vy, qx, qy, qxx, qxy, qyx, qyy, qxxx, qxxy, qxyy, qyyy, qyxx, qyyx), with
smth9 applied to qxx/qyy/qxy after the third derivatives are taken and qyx
kept as the unsmoothed qxy, then appends the cyclic wrap column and computes
beta_M and the stationary wavenumber Ks.

The field tensor layout is ``(nlon_wrap, nlat, 18)``, as in the JAX package;
``prepare_time_varying`` stacks one such state per frame of a time-varying
wind, ``(T, nlon_wrap, nlat, 18)``, with the model time of frame 0 and the
frame spacing. ``regrid_to_uniform`` is not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from rwrt_tpu_torch.constants import pi
from rwrt_tpu_torch.ops import grid as g

#: Order of the stacked background fields.
FIELD_NAMES = (
    "u", "v", "ux", "uy", "vx", "vy",
    "qx", "qy", "qxx", "qxy", "qyx", "qyy",
    "qxxx", "qxxy", "qxyy", "qyyy", "qyxx", "qyyx",
)
NUM_FIELDS = len(FIELD_NAMES)


def as_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype, a numpy dtype or a name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, np.dtype(dtype).name)


class BasicState(NamedTuple):
    """Background state sampled by the ray integrator.

    Attributes:
      fields: (nlon + xcyclic, nlat, 18) stacked derivative fields, or
        (T, nlon + xcyclic, nlat, 18) for a time-varying state.
      lon: (nlon,) longitudes in radians, ascending from lon[0].
      lat: (nlat,) latitudes in radians, ascending.
      betam: (nlon, nlat) Mercator beta; undef at pole rows ((T, ...) for
        a time-varying state, as ks and q).
      ks: (nlon, nlat) stationary wavenumber; undef where invalid.
      q: (nlon, nlat) absolute vorticity.
      xcyclic: whether lon wraps.
      bg_t0, bg_dt: model time (s) of frame 0 and the frame spacing of a
        time-varying state.
    """

    fields: torch.Tensor
    lon: torch.Tensor
    lat: torch.Tensor
    betam: torch.Tensor
    ks: torch.Tensor
    q: torch.Tensor
    xcyclic: bool
    bg_t0: float = 0.0
    bg_dt: float = 1.0

    @property
    def nlon(self) -> int:
        return self.lon.shape[0]

    @property
    def nlat(self) -> int:
        return self.lat.shape[0]

    @property
    def dx(self):
        return 2.0 * pi / self.nlon

    @property
    def dy(self):
        return pi / (self.nlat - 1)


def _check_uniform_axis(coord: np.ndarray, step: float, name: str,
                        expect: str) -> None:
    """Refuse non-uniform or partial-coverage coordinate axes loudly: the
    FD stencils and the fractional-index samplers assume the uniform global
    spacing dx = 2*pi/nlon, dy = pi/(nlat-1)."""
    if not np.all(np.diff(coord) > 0):
        raise ValueError(
            f"{name} must be strictly ascending (flip descending grids "
            "before calling prepare)"
        )
    spacing = np.diff(coord)
    # Absolute floor: coordinates stored as float32 degrees carry rounding
    # up to ~5.3e-7 rad in adjacent spacing near 360 degrees.
    tol = max(1e-5 * step, 1.5e-6)
    dev = float(np.abs(spacing - step).max())
    if dev > tol:
        raise ValueError(
            f"{name} axis is not the uniform {expect} grid the compute "
            f"pipeline assumes: spacing deviates from {step:.6e} rad by up "
            f"to {dev:.3e} rad (tolerance {tol:.1e}). Regrid it first "
            "(rwrt_tpu.models.basic_state.regrid_to_uniform; not ported "
            "yet)."
        )


def _prepare_jit(u, v, lat, dx, dy, xcyclic: bool):
    """The derivative pipeline (a plain function here; the name follows the
    JAX package's jitted counterpart)."""
    q = g.absolute_vorticity(u, v, lat, dx, dy)

    ux = g.gradient_x(u, dx)
    uy = g.gradient_y(u, dy)
    vx = g.gradient_x(v, dx)
    vy = g.gradient_y(v, dy)
    qx = g.gradient_x(q, dx)
    qy = g.gradient_y(q, dy)
    uyy = g.gradient_yy(u, dy)
    qxx = g.gradient_xx(q, dx)
    qyy = g.gradient_yy(q, dy)
    qxy = g.gradient_xy(q, dx, dy)
    # qyx is the UNsmoothed qxy.
    qyx = qxy
    # Third derivatives come from the UNsmoothed second derivatives.
    qxxx = g.gradient_x(qxx, dx)
    qxxy = g.gradient_y(qxx, dy)
    qxyy = g.gradient_y(qxy, dy)
    qyyy = g.gradient_y(qyy, dy)
    qyxx = g.gradient_x(qxy, dx)
    qyyx = g.gradient_x(qyy, dx)

    qxx = g.smth9(qxx)
    qyy = g.smth9(qyy)
    qxy = g.smth9(qxy)

    fields = torch.stack(
        [u, v, ux, uy, vx, vy, qx, qy, qxx, qxy, qyx, qyy,
         qxxx, qxxy, qxyy, qyyy, qyxx, qyyx],
        dim=-1,
    )
    if xcyclic:
        fields = torch.cat([fields, fields[0:1]], dim=0)

    betam = g.betam_field(u, uy, uyy, lat)
    ks = g.stationary_wavenumber(betam, u, lat)
    return fields, betam, ks, q


def _roll_lon_canonical(u, v, lon):
    """Roll the grid so longitude starts at its smallest value mod 2*pi.

    Exact (the grid is periodic in lon); anchors the edge quirks of smth9 and
    the mixed derivative at the 0-degree seam whatever the input's lon
    convention.
    """
    lon = np.asarray(lon, np.float64) % (2.0 * pi)
    k = int(np.argmin(lon))
    if k == 0:
        return u, v, lon
    return (torch.roll(u, -k, dims=-2), torch.roll(v, -k, dims=-2),
            np.roll(lon, -k))


def _grid(u, v, lat, lon, cal_dtype):
    """The axis checks and the canonical roll of ``prepare``, on (..., nlon,
    nlat) winds: returns (u, v, lat, lon, dx, dy), lat and lon as tensors
    of ``cal_dtype`` on u's device, dx and dy as 0-d ones."""
    nlon, nlat = u.shape[-2:]
    if nlon < 2 or nlat < 2:
        raise ValueError("need at least 2 points per axis")
    dx = 2.0 * pi / nlon
    dy = pi / (nlat - 1)
    if lat is not None:
        _check_uniform_axis(np.asarray(lat), dy, "lat",
                            "pole-to-pole (nlat-1 equal steps of pi/(nlat-1))")
    if lon is not None:
        _check_uniform_axis(np.asarray(lon), dx, "lon",
                            "global (nlon equal steps of 2*pi/nlon)")
    if lat is None:
        lat = -pi * 0.5 + np.arange(nlat) * dy
    if lon is None:
        lon = np.arange(nlon) * dx
    u, v, lon = _roll_lon_canonical(u, v, lon)

    def tensor(x):
        return torch.as_tensor(np.asarray(x)).to(device=u.device,
                                                 dtype=cal_dtype)

    return u, v, tensor(lat), tensor(lon), tensor(dx), tensor(dy)


def prepare(
    u,
    v,
    lat=None,
    lon=None,
    *,
    xcyclic: bool = True,
    read_dtype=torch.float32,
    cal_dtype=torch.float32,
    device: torch.device | str = "cuda",
) -> BasicState:
    """Build the BasicState from a gridded wind field.

    Args:
      u, v: (nlon, nlat) zonal/meridional wind, cast through ``read_dtype``
        and then to ``cal_dtype``.
      lat, lon: coordinates in RADIANS, ascending; None = the regular global
        grid (lat from -pi/2 to pi/2, lon from 0).
      xcyclic: append the cyclic wrap column.
      device: where the state lives (default: the card; pass "cpu" to
        run on the host).
    """
    read_dtype = as_dtype(read_dtype)
    cal_dtype = as_dtype(cal_dtype)
    u = torch.as_tensor(np.asarray(u)).to(device=device, dtype=read_dtype)
    v = torch.as_tensor(np.asarray(v)).to(device=device, dtype=read_dtype)
    if u.ndim != 2 or u.shape != v.shape:
        raise ValueError(f"u/v must be matching 2-D (nlon, nlat); got "
                         f"{tuple(u.shape)} vs {tuple(v.shape)}")
    u, v, lat, lon, dx, dy = _grid(u, v, lat, lon, cal_dtype)
    fields, betam, ks, q = _prepare_jit(u.to(cal_dtype), v.to(cal_dtype),
                                        lat, dx, dy, xcyclic)
    return BasicState(
        fields=fields, lon=lon, lat=lat, betam=betam, ks=ks, q=q,
        xcyclic=xcyclic,
    )


def prepare_time_varying(
    u,
    v,
    lat=None,
    lon=None,
    *,
    bg_t0: float = 0.0,
    bg_dt: float,
    xcyclic: bool = True,
    read_dtype=torch.float32,
    cal_dtype=torch.float32,
    device: torch.device | str = "cuda",
) -> BasicState:
    """Build a time-varying BasicState from (T, nlon, nlat) wind frames.

    Each frame runs through ``prepare``'s precompute; fields, betam, ks and
    q are stacked over the frames. The ray RHS lerps the stack linearly in
    time at each lane's own time (exact, since every derived field is
    linear in u, v). ``bg_t0`` and ``bg_dt`` are the model time (seconds)
    of frame 0 and the frame spacing; before frame 0 and after the last
    frame the sample holds the end frame. Arguments otherwise as
    ``prepare``'s.
    """
    read_dtype = as_dtype(read_dtype)
    cal_dtype = as_dtype(cal_dtype)
    u = torch.as_tensor(np.asarray(u)).to(device=device, dtype=read_dtype)
    v = torch.as_tensor(np.asarray(v)).to(device=device, dtype=read_dtype)
    if u.ndim != 3 or u.shape != v.shape:
        raise ValueError(f"u/v must be matching 3-D (T, nlon, nlat); got "
                         f"{tuple(u.shape)} vs {tuple(v.shape)}")
    u, v, lat, lon, dx, dy = _grid(u.to(cal_dtype), v.to(cal_dtype), lat,
                                   lon, cal_dtype)
    frames = [_prepare_jit(uu, vv, lat, dx, dy, xcyclic)
              for uu, vv in zip(u, v)]
    fields, betam, ks, q = (torch.stack(x) for x in zip(*frames))
    return BasicState(
        fields=fields, lon=lon, lat=lat, betam=betam, ks=ks, q=q,
        xcyclic=xcyclic, bg_t0=float(bg_t0), bg_dt=float(bg_dt),
    )
