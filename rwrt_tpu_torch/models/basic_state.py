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
frame spacing. ``regrid_to_uniform`` is the host-side bilinear regrid
onto that uniform grid for the inputs ``prepare`` refuses (numpy, as in the
JAX package).
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
            f"to {dev:.3e} rad (tolerance {tol:.1e}). "
            "Regrid first: basic_state.regrid_to_uniform(u, v, lat, lon)."
        )


def regrid_to_uniform(u, v, lat, lon, nlat=None, nlon=None):
    """Bilinearly regrid winds from any monotonic grid onto the uniform grid.

    Host-side, one-time preprocessing in numpy for inputs that ``prepare``
    refuses (Gaussian reanalysis grids, regional subsets, ...). The interval
    lookup is a searchsorted on the actual monotonic axes, and the longitude
    axis is cyclic.

    Args:
      u, v: (nlon_in, nlat_in) winds on the source grid.
      lat, lon: source coordinates in radians, ascending.
      nlat, nlon: target resolution; defaults to the source counts (nlat
        forced odd so the equator is a grid row, matching pole-to-pole
        spacing pi/(nlat-1)).

    Returns:
      (u_out, v_out, lat_out, lon_out) on the uniform global grid.
    """
    u = np.asarray(u)
    v = np.asarray(v)
    lat = np.asarray(lat, np.float64)
    lon = np.asarray(lon, np.float64)
    if nlat is None:
        nlat = lat.shape[0] if lat.shape[0] % 2 == 1 else lat.shape[0] + 1
    if nlon is None:
        nlon = lon.shape[0]
    lat_out = -0.5 * pi + np.arange(nlat) * (pi / (nlat - 1))
    lon_out = np.arange(nlon) * (2.0 * pi / nlon)

    # Cyclic extension in lon so targets beyond the last source column
    # interpolate across the wrap.
    lon_ext = np.concatenate([lon, lon[:1] + 2.0 * pi])

    def interp_axis(coord, targets):
        """Interval index + fractional weight, clamped at the ends."""
        i0 = np.clip(np.searchsorted(coord, targets, side="right") - 1,
                     0, coord.shape[0] - 2)
        wgt = (targets - coord[i0]) / (coord[i0 + 1] - coord[i0])
        return i0, np.clip(wgt, 0.0, 1.0)

    # Map each target into the source's own cyclic window [lon[0],
    # lon[0]+2*pi), so a -180..180 source interpolates across its seam.
    jx, wx = interp_axis(lon_ext, lon[0] + (lon_out - lon[0]) % (2.0 * pi))
    jy, wy = interp_axis(lat, np.clip(lat_out, lat[0], lat[-1]))
    jx1 = jx + 1

    def regrid(f):
        f_ext = np.concatenate([f, f[:1]], axis=0)
        c00 = f_ext[jx[:, None], jy[None, :]]
        c10 = f_ext[jx1[:, None], jy[None, :]]
        c01 = f_ext[jx[:, None], jy[None, :] + 1]
        c11 = f_ext[jx1[:, None], jy[None, :] + 1]
        wxg = wx[:, None]
        wyg = wy[None, :]
        return ((1 - wxg) * (1 - wyg) * c00 + wxg * (1 - wyg) * c10
                + (1 - wxg) * wyg * c01 + wxg * wyg * c11)

    return regrid(u), regrid(v), lat_out, lon_out


def _wind(x, device, dtype) -> torch.Tensor:
    """A wind argument on ``device`` in ``dtype``: a tensor as it is, its
    autograd graph kept (a gradient may flow back to it), anything else
    through numpy."""
    if not torch.is_tensor(x):
        x = torch.as_tensor(np.asarray(x))
    return x.to(device=device, dtype=dtype)


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
        and then to ``cal_dtype``. A tensor keeps its autograd graph, so
        the state is differentiable in the wind.
      lat, lon: coordinates in RADIANS, ascending; None = the regular global
        grid (lat from -pi/2 to pi/2, lon from 0).
      xcyclic: append the cyclic wrap column.
      device: where the state lives (default: the card; pass "cpu" to
        run on the host).
    """
    read_dtype = as_dtype(read_dtype)
    cal_dtype = as_dtype(cal_dtype)
    u = _wind(u, device, read_dtype)
    v = _wind(v, device, read_dtype)
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
    u = _wind(u, device, read_dtype)
    v = _wind(v, device, read_dtype)
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
