"""Grid-wide wavenumber diagnostics: mwn roots and group velocities everywhere.

Port of ``rwrt_tpu/diagnostics/wavenumber.py``: the stationary and
non-stationary wavenumber maps of Hoskins & Ambrizzi 1993 / Hoskins & Yang
1996, as one vectorized solve over the whole (nlon x nlat x nzwn) grid on
the state's device, through the port's sampler (``ops/interp``), the
closed-form dispersion cubic (``ops/cubic``) and group velocity
(``ops/groupvel``).

Also the NaN in-fill helpers; as in the JAX package, in-filling is NOT
applied by default (callers opt in with ``postprocess_maps``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from rwrt_tpu_torch.models.basic_state import BasicState
from rwrt_tpu_torch.ops import interp
from rwrt_tpu_torch.ops.cubic import solve_dispersion_cubic
from rwrt_tpu_torch.ops.groupvel import group_velocity
from rwrt_tpu_torch.parallel import sharding
from rwrt_tpu_torch.solvers.rk45 import as_scalar


class WavenumberMaps(NamedTuple):
    """Gridded diagnostics, shapes (nlon, nlat, nzwn, 3) / (nlon, nlat,
    nzwn), with a leading time axis for a time-varying state."""

    mwn: torch.Tensor      # meridional wavenumber roots
    rootnum: torch.Tensor  # number of real propagating roots
    ug: torch.Tensor       # zonal group velocity per root
    vg: torch.Tensor       # meridional group velocity per root


def _compute_points(fields, lon0, lat0, dx, dy, lon_pts, lat_pts, zwn, freq):
    """Flat per-point solve: (npts,) positions -> (npts, nzwn, 3) products."""
    f = interp.sample_mercator(fields, lon0, lat0, dx, dy, lon_pts, lat_pts)
    fmu, fmv = f[interp.M_U], f[interp.M_V]
    fmqx, fmqy = f[interp.M_QX], f[interp.M_QY]

    roots, count = solve_dispersion_cubic(
        fmu[:, None], fmv[:, None], fmqx[:, None], fmqy[:, None],
        freq, zwn[None, :],
    )  # (npts, nzwn, 3), (npts, nzwn)

    ug, vg = group_velocity(
        fmu[:, None, None], fmv[:, None, None],
        fmqx[:, None, None], fmqy[:, None, None],
        zwn[None, :, None], roots,
    )
    # Rootless slots get 0 group velocity.
    dead = torch.isnan(roots)
    ug = torch.where(dead, torch.zeros_like(ug), ug)
    vg = torch.where(dead, torch.zeros_like(vg), vg)
    return roots, count, ug, vg


def compute_wavenumber_maps(bs: BasicState, zwn, freq: float = 0.0, *,
                            mesh=None) -> WavenumberMaps:
    """Solve the dispersion relation at EVERY grid point x zonal wavenumber,
    on the state's device.

    mesh: optional ``parallel.sharding.Mesh`` of the state's device type:
    the flattened grid-point axis padded with NaN points to a multiple of
    the mesh size and split over its entries, the field stack copied to
    every device, the products gathered on the state's device. A point's
    solve reads no other point, so the maps are those of the solve without
    a mesh.

    A time-varying BasicState (4-D field stack) maps frame by frame: every
    product gains a leading time axis of length T.
    """
    mesh = sharding.check_mesh(mesh, bs.fields.device)
    if bs.fields.ndim == 4:
        frames = [
            compute_wavenumber_maps(
                bs._replace(fields=bs.fields[ti], betam=bs.betam[ti],
                            ks=bs.ks[ti], q=bs.q[ti]),
                zwn, freq, mesh=mesh)
            for ti in range(bs.fields.shape[0])
        ]
        return WavenumberMaps(*(torch.stack(x) for x in zip(*frames)))
    dtype = bs.fields.dtype
    dev = bs.fields.device
    nlon, nlat = bs.lon.shape[0], bs.lat.shape[0]
    lon_pts = torch.repeat_interleave(bs.lon.to(dtype), nlat)
    lat_pts = bs.lat.to(dtype).repeat(nlon)
    scalars = tuple(as_scalar(x, dtype)
                    for x in (bs.lon[0], bs.lat[0], bs.dx, bs.dy))
    zwn_d = torch.as_tensor(np.asarray(zwn, np.float64)).to(
        device=dev, dtype=dtype).reshape(-1)
    freq_d = as_scalar(freq, dtype)
    if mesh is None:
        roots, count, ug, vg = _compute_points(
            bs.fields, *scalars, lon_pts, lat_pts, zwn_d, freq_d)
    else:
        npts = lon_pts.shape[0]
        lons, lats = (
            sharding.shard_rays(sharding.pad_rays(x, mesh.size)[0], mesh)
            for x in (lon_pts, lat_pts))
        reps = sharding.replicate((bs.fields, zwn_d), mesh)
        outs = []
        for d, lo, la, (fields, z) in zip(mesh.devices, lons, lats, reps):
            with sharding.device_guard(d):
                outs.append(_compute_points(fields, *scalars, lo, la, z,
                                            freq_d))
        roots, count, ug, vg = (
            torch.cat([o[k].to(dev) for o in outs])[:npts]
            for k in range(4))
    shape4 = (nlon, nlat, zwn_d.shape[0], 3)
    return WavenumberMaps(
        mwn=roots.reshape(shape4),
        rootnum=count.reshape(shape4[:3]),
        ug=ug.reshape(shape4),
        vg=vg.reshape(shape4),
    )


def fill_nan_neighborhood_mean(arr: torch.Tensor,
                               size: int = 3) -> torch.Tensor:
    """Replace NaNs by the mean of valid neighbours in a size x size window
    over the leading two (lon, lat) axes, both wrapping."""
    mask = torch.isnan(arr)
    filled0 = torch.where(mask, torch.zeros_like(arr), arr)
    weight = (~mask).to(arr.dtype)
    half = size // 2

    def window_sum(x):
        total = torch.zeros_like(x)
        for di in range(-half, half + 1):
            rolled = torch.roll(x, di, dims=0)  # lon wraps
            for dj in range(-half, half + 1):
                # lat edges wrap too (uniform_filter's mode='wrap').
                total = total + torch.roll(rolled, dj, dims=1)
        return total

    s = window_sum(filled0)
    w = window_sum(weight)
    fill = s / torch.where(w == 0.0, torch.ones_like(w), w)
    fill = torch.where(w == 0.0, torch.full_like(fill, float("nan")), fill)
    return torch.where(mask, fill, arr)


def postprocess_maps(maps: WavenumberMaps, size: int = 3) -> WavenumberMaps:
    """NaN-fill the map product by neighbourhood means (ug, vg, mwn;
    rootnum untouched). Windows with zero valid neighbours stay NaN."""
    return WavenumberMaps(
        mwn=fill_nan_neighborhood_mean(maps.mwn, size),
        rootnum=maps.rootnum,
        ug=fill_nan_neighborhood_mean(maps.ug, size),
        vg=fill_nan_neighborhood_mean(maps.vg, size),
    )


def turning_critical_masks(bs: BasicState, zwn) -> torch.Tensor:
    """Turning/critical-latitude masks per zonal wavenumber.

    A wave with dimensionless wavenumber k can propagate where Ks > k
    (critical latitude where u -> 0 => Ks -> inf is never masked; turning
    latitude where Ks == k). Returns bool (nlon, nlat, nzwn): True where
    propagation is allowed.
    """
    ks = bs.ks[..., None]
    k = torch.as_tensor(np.asarray(zwn, np.float64),
                        device=ks.device).reshape(1, 1, -1)
    return torch.isfinite(ks) & (ks > k)
