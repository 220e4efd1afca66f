"""Along-ray Li-Yang wave-ray flux (WRF) diagnostics.

Port of ``rwrt_tpu/diagnostics/flux.py``, the manual's WRF pipeline
(section 4): Fun1's thresholds (``threshold_filter``: group-speed bounds, a
meridional-wavenumber cap, amplitude bounds), Fun2's target region
(``region_mask``: rays that ever enter the box), and Fun3's gridded flux
maps (``wave_ray_flux``) and region aggregates (``region_statistics``)
over the unwrapped longitude axis (-360..720 degrees, the manual's three
longitude circles). ``weight`` selects the cell integrand: ``'count'``
(unit direction vectors), ``'cg'`` (group velocity) or ``'amp_cg'`` (the
signed amplitude times the group velocity).

The binning is a hand-written kernel (``csrc/flux.cu``): on a CUDA
trajectory ``wave_ray_flux`` calls it once (after the region pass where a
target region is given): the kept rays' list, an unwrap pass whose only
sequential part is the running sum, in its order, then a point pass over
every (row, kept ray) point in parallel, the thresholds, the bins and the
scatter-adds, the adds of a warp's points in one cell summed first.
On a CPU trajectory the plain PyTorch versions run (``_accumulate_plain``,
``_region_plain``). ``LAUNCHES`` and ``REGION_LAUNCHES`` count the
binning's and the region pass's calls (the binning's launches count as
one). ``wave_ray_flux_chunked`` walks a host-resident (or
memmap) history in time blocks, copies each block to the device and
chains the unwrap's carry through the kernel. ``region_statistics`` is
host numpy, as in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from rwrt_tpu_torch import kernels
from rwrt_tpu_torch.constants import deg2rad, pi, rearth
from rwrt_tpu_torch.convert import host
from rwrt_tpu_torch.ops.interp import true_div
from rwrt_tpu_torch.solvers.rk45 import as_scalar
from rwrt_tpu_torch.tracer import RayTrajectories

#: Launches of the binning kernel, and of the region pass, in this process.
LAUNCHES = 0
REGION_LAUNCHES = 0

#: The cell integrands, by the id the kernel takes.
WEIGHTS = {"count": 0, "cg": 1, "amp_cg": 2}


class WaveRayFlux(NamedTuple):
    """Accumulated flux maps on the diagnostic grid.

    lon_centers spans -360..720 degrees (the manual's three-circle scope);
    maps shaped (nlon_bins, nlat_bins), in the trajectories' dtype
    (float64 from ``wave_ray_flux_chunked``, which sums its blocks so).
    """

    lon_centers: torch.Tensor
    lat_centers: torch.Tensor
    flux_u: torch.Tensor    # sum of w * ug_hat per cell (see `weight`)
    flux_v: torch.Tensor    # sum of w * vg_hat per cell
    amp_sum: torch.Tensor   # sum of |amp| per cell
    count: torch.Tensor     # ray-point count per cell


class RegionStatistics(NamedTuple):
    """Aggregates over rays passing through a target region (the manual's
    Fun3 extras: average propagation time, average speed, wave sources)."""

    n_passing: int
    mean_entry_time: float      # seconds to first entry (entry-at-seed = 0)
    mean_speed: float           # m/s along-path up to first entry
    first_entry_step: np.ndarray  # (3, nsource, nzwn); -1 = never enters
    source_lon: np.ndarray      # seeds of passing rays, radians
    source_lat: np.ndarray


class Thresholds(NamedTuple):
    """Fun1's thresholds; None switches a check off."""

    amp_min: float = 0.0
    amp_max: float = float("inf")
    speed_min: Optional[float] = None
    speed_max: Optional[float] = None
    mwn_max: Optional[float] = None


def _tensor(x, device=None) -> torch.Tensor:
    """A trajectory field as a tensor (numpy and memmaps on the CPU)."""
    if not torch.is_tensor(x):
        x = np.ascontiguousarray(x)
        x = torch.from_numpy(x if x.flags.writeable else x.copy())
    return x if device is None else x.to(device)


def _valid(lon, lat, amp, ug, vg, ky, th: Thresholds) -> torch.Tensor:
    """Fun1's per-point mask; every bound rounded to the fields' dtype."""
    dt = lon.dtype
    aabs = torch.abs(amp)
    valid = (torch.isfinite(lon) & torch.isfinite(lat) & torch.isfinite(amp)
             & (aabs >= as_scalar(th.amp_min, dt))
             & (aabs <= as_scalar(th.amp_max, dt)))
    if th.speed_min is not None or th.speed_max is not None:
        speed = torch.sqrt(ug * ug + vg * vg)
        if th.speed_min is not None:
            valid = valid & (speed >= as_scalar(th.speed_min, dt))
        if th.speed_max is not None:
            valid = valid & (speed <= as_scalar(th.speed_max, dt))
    if th.mwn_max is not None:
        valid = valid & (torch.abs(ky) < as_scalar(th.mwn_max, dt))
    return valid


def threshold_filter(
    traj: RayTrajectories,
    amp_min: float = 0.0,
    amp_max: float = float("inf"),
    speed_min: Optional[float] = None,
    speed_max: Optional[float] = None,
    mwn_max: Optional[float] = None,
) -> torch.Tensor:
    """Per-point validity mask (Fun1_threshold): finite position and
    amplitude, |amp| within [amp_min, amp_max], the group speed |cg| within
    [speed_min, speed_max] and |m| < mwn_max where those are set."""
    return _valid(*(_tensor(getattr(traj, k))
                    for k in ("lon", "lat", "amp", "ug", "vg", "ky")),
                  Thresholds(amp_min, amp_max, speed_min, speed_max,
                             mwn_max))


def _box(lon_range, lat_range, dtype):
    """The box as the kernel takes it: (mode, lo0, lo1, la0, la1), mode 0
    a full circle, 1 a plain longitude span, 2 one across the date line;
    the bounds rounded to ``dtype``."""
    if lon_range[1] - lon_range[0] >= 360.0:
        mode, lo0, lo1 = 0, 0.0, 0.0
    else:
        lo0, lo1 = lon_range[0] % 360.0, lon_range[1] % 360.0
        mode = 1 if lo1 >= lo0 else 2
    return (mode, *(as_scalar(x, dtype)
                    for x in (lo0, lo1, lat_range[0], lat_range[1])))


def _in_box_arrays(lon, lat, amp, lon_range, lat_range):
    """(rows...) bool: LIVE point inside the target box. Numpy in, numpy
    out (the host walkers); tensors in, a tensor out on their device.

    Gates on amplitude finiteness, not just position: never-born rootless
    lanes keep a finite frozen seed position at every step, and must not
    count as rays passing through the box.
    """
    if not torch.is_tensor(lon):
        return _in_box_arrays(*(_tensor(x) for x in (lon, lat, amp)),
                              lon_range, lat_range).numpy()
    mode, lo0, lo1, la0, la1 = _box(lon_range, lat_range, lon.dtype)
    lon_deg = torch.remainder(true_div(lon, deg2rad), 360.0)
    lat_deg = true_div(lat, deg2rad)
    if mode == 0:
        in_lon = torch.ones_like(lon_deg, dtype=torch.bool)
    elif mode == 1:
        in_lon = (lon_deg >= lo0) & (lon_deg <= lo1)
    else:
        in_lon = (lon_deg >= lo0) | (lon_deg <= lo1)
    in_box = in_lon & (lat_deg >= la0) & (lat_deg <= la1)
    return (in_box & torch.isfinite(lon) & torch.isfinite(lat)
            & torch.isfinite(amp))


def _in_box(traj: RayTrajectories, lon_range, lat_range):
    """(nt, 3, nsource, nzwn) bool: LIVE point inside the target box."""
    return _in_box_arrays(traj.lon, traj.lat, traj.amp, lon_range,
                          lat_range)


def _rows(x: torch.Tensor) -> torch.Tensor:
    """x as (nt, R) rows, each row contiguous (a view where it can be)."""
    v = x.reshape(x.shape[0], -1)
    return v if v.shape[1] <= 1 or v.stride(1) == 1 else v.contiguous()


def _region_plain(lon, lat, amp, keep, lon_range, lat_range):
    """The plain version of the region pass over (nt, R) rows: ``keep``
    (R,) OR-ed with "a live point of these rows lies in the box"."""
    return keep | _in_box_arrays(lon, lat, amp, lon_range, lat_range).any(0)


def _region_cuda(lon, lat, amp, keep, lon_range, lat_range):
    """Launch the region pass over the (nt, R) rows, OR-ing into a copy
    of ``keep``: 32 rays a block, their rows in tiles of 64, each ray's
    reads ending with the tile of its first live point in the box (none
    for a ray ``keep`` already holds)."""
    global REGION_LAUNCHES
    lon, lat, amp = (_rows(x) for x in (lon, lat, amp))
    nt, r = lon.shape
    dev, dt = lon.device, lon.dtype
    for name, x in (("lat", lat), ("amp", amp)):
        if x.shape != lon.shape:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, lon "
                             f"{tuple(lon.shape)}")
        if x.device != dev or x.dtype != dt:
            raise ValueError(f"{name} is {x.dtype} on {x.device}, lon "
                             f"{dt} on {dev}")
    keep = keep.clone()
    kernels.check_tensor(keep, "keep", device=dev, dtype=torch.bool,
                         shape=(r,))
    kernels.launch("rwrt_flux_region", dt, lon, lat, amp, lon.stride(0),
                   lat.stride(0), amp.stride(0), nt, r,
                   *_box(lon_range, lat_range, dt), keep,
                   kernels.stream(dev))
    REGION_LAUNCHES += 1
    return keep


def _region(lon, lat, amp, keep, lon_range, lat_range):
    run = _region_cuda if lon.is_cuda else _region_plain
    return run(lon, lat, amp, keep, lon_range, lat_range)


def region_mask(traj: RayTrajectories, lon_range, lat_range) -> torch.Tensor:
    """True for rays that enter the target box at any time
    (Fun2_region_threshold). Returns (3, nsource, nzwn) on the
    trajectories' device: one region-pass launch on the card."""
    lon, lat, amp = (_tensor(getattr(traj, k)) for k in ("lon", "lat", "amp"))
    keep = torch.zeros(lon[0].numel(), dtype=torch.bool, device=lon.device)
    return _region(_rows(lon), _rows(lat), _rows(amp), keep, lon_range,
                   lat_range).reshape(lon.shape[1:])


def _hop_lengths(lon, lat):
    """Great-circle lengths between consecutive rows (radians); NaN -> 0."""
    dlon = lon[1:] - lon[:-1]
    dlat = lat[1:] - lat[:-1]
    a = (np.sin(dlat / 2.0) ** 2
         + np.cos(lat[:-1]) * np.cos(lat[1:]) * np.sin(dlon / 2.0) ** 2)
    a = np.clip(a, 0.0, 1.0)
    hop = 2.0 * np.arctan2(np.sqrt(a), np.sqrt(1.0 - a))
    return np.where(np.isfinite(hop), hop, 0.0)


def region_statistics(
    traj: RayTrajectories,
    lon_range,
    lat_range,
    tstep: float,
    source_lon=None,
    source_lat=None,
    time_block: Optional[int] = None,
) -> RegionStatistics:
    """Fun3's target-region aggregates: how many rays reach the box, the
    average propagation time to first entry, the average along-path speed up
    to entry (great-circle path length / entry time; rays seeded inside the
    box are excluded from the speed average), and the seed positions of the
    passing rays. Host numpy, on the three fields it reads.

    time_block: walk the time axis in blocks of this many output steps (the
    first-entry search and the cumulative path length chain exactly through
    per-block carries), so memmap-backed streamed histories never
    materialize in full. None = one pass over the whole history.
    """
    if time_block is not None and int(time_block) < 1:
        raise ValueError(f"time_block must be >= 1, got {time_block}")
    nt = int(traj.lon.shape[0])
    blk = nt if not time_block else int(time_block)

    first = None          # (3, nsource, nzwn) first-entry step; -1 = never
    path_at_first = None  # path length (radians) at first entry
    carry_cum = None      # running path length at the last row walked
    prev_lon = prev_lat = None
    src_row = None
    for t0 in range(0, nt, blk):
        t1 = min(nt, t0 + blk)
        lon = host(traj.lon[t0:t1])
        lat = host(traj.lat[t0:t1])
        amp = host(traj.amp[t0:t1])
        in_box = _in_box_arrays(lon, lat, amp, lon_range, lat_range)
        if first is None:
            shape = in_box.shape[1:]
            first = np.full(shape, -1, dtype=np.int64)
            path_at_first = np.zeros(shape)
            src_row = (lon[0], lat[0])
            hop = _hop_lengths(lon, lat)
            # Path length up to each row: cumsum with a zero row on top.
            cum_rows = np.concatenate(
                [np.zeros((1,) + shape), np.cumsum(hop, 0)])
        else:
            hop = _hop_lengths(np.concatenate([prev_lon[None], lon]),
                               np.concatenate([prev_lat[None], lat]))
            cum_rows = carry_cum[None] + np.cumsum(hop, 0)
        carry_cum = cum_rows[-1]
        prev_lon, prev_lat = lon[-1], lat[-1]

        blk_any = in_box.any(axis=0)
        blk_first = in_box.argmax(axis=0)
        newly = (first < 0) & blk_any
        first = np.where(newly, t0 + blk_first, first)
        pick = np.take_along_axis(cum_rows, blk_first[None], axis=0)[0]
        path_at_first = np.where(newly, pick, path_at_first)

    passes = first >= 0
    entered = first > 0
    times = first[entered] * tstep
    speeds = path_at_first[entered] * rearth / np.maximum(times, 1e-30)

    n_passing = int(passes.sum())
    mean_entry_time = (
        float((first[passes] * tstep).mean()) if n_passing else float("nan")
    )
    mean_speed = float(speeds.mean()) if entered.any() else float("nan")

    if source_lon is None:
        src_lon, src_lat = src_row
    else:
        shape = passes.shape
        src_lon = np.broadcast_to(
            np.asarray(source_lon)[None, :, None], shape)
        src_lat = np.broadcast_to(
            np.asarray(source_lat)[None, :, None], shape)
    return RegionStatistics(
        n_passing=n_passing,
        mean_entry_time=mean_entry_time,
        mean_speed=mean_speed,
        first_entry_step=first,
        source_lon=np.asarray(src_lon)[passes],
        source_lat=np.asarray(src_lat)[passes],
    )


def _unwrap_lon_block(lon_rad: torch.Tensor, carry=None):
    """Continuous longitude along each ray (time axis 0), radians, with an
    optional carry so long histories can be processed in time blocks.

    Starts in [0, 2*pi) and accumulates increments mapped to (-pi, pi], so a
    ray circling the globe keeps increasing/decreasing past 360 deg. Output
    is clipped to the manual's -360..720 degree bookkeeping span ("three
    longitude circles"); the carry (two rows shaped (1, ...)) keeps the
    UNCLIPPED accumulator and the last wrapped row, so chaining blocks is
    the one-shot unwrap up to the cumulative sum's order. NaN rows (dead
    steps) contribute zero increment and emit NaN. The cumulative sum runs
    row by row from zero, as the kernel's does.
    """
    base = torch.remainder(lon_rad, 2.0 * pi)
    if carry is None:
        start = base[:1]
        d = base[1:] - base[:-1]
    else:
        u_prev, base_prev = carry
        start = u_prev
        d = base - torch.cat([base_prev, base[:-1]])
    d = torch.remainder(d + pi, 2.0 * pi) - pi
    d = torch.where(torch.isnan(d), torch.zeros_like(d), d)
    cum = torch.empty_like(d)
    acc = torch.zeros_like(start[0])
    for t in range(d.shape[0]):
        acc = acc + d[t]
        cum[t] = acc
    if carry is None:
        unwrapped = torch.cat([start, start + cum])
    else:
        unwrapped = start + cum
    new_carry = (unwrapped[-1:], base[-1:])
    unwrapped = torch.where(torch.isnan(base),
                            torch.full_like(unwrapped, float("nan")),
                            unwrapped)
    return torch.clamp(unwrapped, -2.0 * pi, 4.0 * pi), new_carry


def _unwrap_lon(lon_rad: torch.Tensor) -> torch.Tensor:
    """One-shot form of `_unwrap_lon_block` (whole history at once)."""
    return _unwrap_lon_block(lon_rad)[0]


def _bin_scales(nlon_bins: int, nlat_bins: int, dtype) -> tuple:
    """(1 / dlon, 1 / dlat), each the reciprocal of the cell width taken
    in ``dtype``: inside its jitted ``_accumulate`` XLA folds the division
    by the constant cell width into a multiplication by this reciprocal, so
    the bins are those of ``(lon + 360) * (1 / dlon)``."""
    one = torch.ones((), dtype=dtype)
    return tuple(float(one / torch.tensor(w, dtype=torch.float64).to(dtype))
                 for w in (1080.0 / nlon_bins, 180.0 / nlat_bins))


def _bin_index(x: torch.Tensor, n: int) -> torch.Tensor:
    """JAX's clip(int32(x), 0, n - 1): truncation toward zero, NaN to 0
    (XLA's conversion takes NaN to 0), as int64."""
    xi = torch.clamp(torch.trunc(x), 0, n - 1)
    return torch.where(torch.isnan(xi), torch.zeros_like(xi), xi).long()


def _accumulate_plain(lon, lat, amp, ug, vg, ky, keep, carry, nlon_bins,
                      nlat_bins, th: Thresholds, weight: str):
    """The plain version of the binning kernel over (nt, R) rows: Fun1's
    mask (and the region pass's ``keep``, (R,) or None), the unwrap
    chained from ``carry`` ((u_prev, base_prev), each (R,), or None), the
    bins and the four maps by ``index_add_``. Returns (fu, fv, asum, cnt)
    shaped (nlon_bins, nlat_bins) in the fields' dtype, and the new carry
    (NaN for the rays ``keep`` drops)."""
    valid = _valid(lon, lat, amp, ug, vg, ky, th)
    if keep is not None:
        valid = valid & keep[None]
    lon_u, (u_prev, base_prev) = _unwrap_lon_block(
        lon, None if carry is None else tuple(c[None] for c in carry))
    inv_dlon, inv_dlat = _bin_scales(nlon_bins, nlat_bins, lon.dtype)
    ix = _bin_index((true_div(lon_u, deg2rad) + 360.0) * inv_dlon,
                    nlon_bins)
    iy = _bin_index((true_div(lat, deg2rad) + 90.0) * inv_dlat, nlat_bins)
    flat = (ix * nlat_bins + iy)[valid]
    if weight == "count":
        speed = torch.sqrt(ug * ug + vg * vg)
        safe = torch.where(speed > 0, speed, torch.ones_like(speed))
        wu, wv = ug / safe, vg / safe
    elif weight == "cg":
        wu, wv = ug, vg
    else:
        wu, wv = amp * ug, amp * vg

    def scat(vals):
        out = torch.zeros(nlon_bins * nlat_bins, dtype=lon.dtype,
                          device=lon.device)
        return out.index_add_(0, flat, vals[valid]).reshape(nlon_bins,
                                                            nlat_bins)

    maps = (scat(wu), scat(wv), scat(torch.abs(amp)),
            scat(torch.ones_like(amp)))
    carry = (u_prev[0], base_prev[0])
    if keep is not None:
        # A dropped ray is never binned in any block: its carry is NaN.
        carry = tuple(torch.where(keep, c, torch.full_like(c, float("nan")))
                      for c in carry)
    return maps, carry


def _accumulate_cuda(lon, lat, amp, ug, vg, ky, keep, carry, nlon_bins,
                     nlat_bins, th: Thresholds, weight: str):
    """Launch the binning over (nt, R) rows (each row contiguous, any row
    stride): the kept rays' list, the unwrap pass (32 kept rays a block,
    the running sum in order), the point pass over every (row, kept ray)
    point, and in float32 the maps from their interleaved sums. Same
    arguments and returns as ``_accumulate_plain``."""
    global LAUNCHES
    fields = {"lon": lon, "lat": lat, "amp": amp, "ug": ug, "vg": vg}
    checks = (int(th.speed_min is not None)
              | int(th.speed_max is not None) << 1
              | int(th.mwn_max is not None) << 2)
    if checks & 4:
        fields["ky"] = ky
    rows = {k: _rows(x) for k, x in fields.items()}
    nt, r = rows["lon"].shape
    dev, dt = lon.device, lon.dtype
    for name, x in rows.items():
        if x.shape != (nt, r) or x.device != dev or x.dtype != dt:
            raise ValueError(f"{name} is {tuple(x.shape)} {x.dtype} on "
                             f"{x.device}; lon {(nt, r)} {dt} on {dev}")
    if dt not in (torch.float32, torch.float64):
        raise ValueError(f"the flux kernel takes float32 or float64, not "
                         f"{dt}")
    if keep is not None:
        kernels.check_tensor(keep, "keep", device=dev, dtype=torch.bool,
                             shape=(r,))
    if carry is None:
        u_prev = torch.empty(r, dtype=dt, device=dev)
        base_prev = torch.empty_like(u_prev)
    else:
        u_prev, base_prev = (c.clone() for c in carry)
        for name, x in (("u_prev", u_prev), ("base_prev", base_prev)):
            kernels.check_tensor(x, name, device=dev, dtype=dt, shape=(r,))
    maps = torch.zeros((4, nlon_bins, nlat_bins), dtype=dt, device=dev)
    ky_rows = rows.get("ky")
    # The kernel's scratch: the kept rays' list and its length, each
    # point's longitude bin, and in float32 the maps' interleaved sums.
    rays = torch.empty(r, dtype=torch.int32, device=dev)
    n_kept = torch.empty(1, dtype=torch.int32, device=dev)
    ixs = torch.empty((nt, r), dtype=torch.int32, device=dev)
    acc = (torch.empty((nlon_bins * nlat_bins, 4), dtype=torch.float32,
                       device=dev) if dt == torch.float32 else None)
    kernels.launch(
        "rwrt_flux", dt, *(rows[k] for k in ("lon", "lat", "amp", "ug",
                                            "vg")), ky_rows,
        *(rows[k].stride(0) for k in ("lon", "lat", "amp", "ug", "vg")),
        0 if ky_rows is None else ky_rows.stride(0), nt, r, keep, u_prev,
        base_prev, int(carry is not None), *maps, nlon_bins, nlat_bins,
        *_bin_scales(nlon_bins, nlat_bins, dt), th.amp_min, th.amp_max,
        *(0.0 if x is None else x for x in (th.speed_min, th.speed_max,
                                            th.mwn_max)),
        checks, WEIGHTS[weight], rays, n_kept, ixs, acc, kernels.stream(dev))
    LAUNCHES += 1
    return tuple(maps), (u_prev, base_prev)


def _accumulate(lon, lat, amp, ug, vg, ky, keep, carry, nlon_bins,
                nlat_bins, th: Thresholds, weight: str):
    if weight not in WEIGHTS:
        raise ValueError(f"unknown weight {weight!r}")
    run = _accumulate_cuda if lon.is_cuda else _accumulate_plain
    return run(lon, lat, amp, ug, vg, ky, keep, carry, nlon_bins, nlat_bins,
               th, weight)


def _centers(nlon_bins, nlat_bins, device):
    dlon = 1080.0 / nlon_bins
    dlat = 180.0 / nlat_bins
    idx = [torch.arange(n, dtype=torch.float64, device=device)
           for n in (nlon_bins, nlat_bins)]
    return -360.0 + (idx[0] + 0.5) * dlon, -90.0 + (idx[1] + 0.5) * dlat


def wave_ray_flux(
    traj: RayTrajectories,
    nlon_bins: int = 360,
    nlat_bins: int = 90,
    amp_min: float = 0.0,
    amp_max: float = float("inf"),
    speed_min: Optional[float] = None,
    speed_max: Optional[float] = None,
    mwn_max: Optional[float] = None,
    lon_range=None,
    lat_range=None,
    weight: str = "amp_cg",
) -> WaveRayFlux:
    """Accumulate Li-Yang wave-ray flux maps (Fun3/WRF_universal pipeline:
    Fun1 thresholds -> optional Fun2 region selection -> gridded flux), on
    the trajectories' device: on the card one launch of the binning kernel
    (after one of the region pass where a box is given).

    The longitude axis spans -360..720 degrees (manual section 4's three
    longitude circles) binned into nlon_bins cells; latitude spans -90..90.
    ``weight`` selects the cell integrand (see the module docstring).
    """
    lon, lat, amp, ug, vg, ky = (
        _rows(_tensor(getattr(traj, k)))
        for k in ("lon", "lat", "amp", "ug", "vg", "ky"))
    keep = None
    if lon_range is not None and lat_range is not None:
        keep = _region(lon, lat, amp, torch.zeros(
            lon.shape[1], dtype=torch.bool, device=lon.device), lon_range,
            lat_range)
    (fu, fv, asum, cnt), _ = _accumulate(
        lon, lat, amp, ug, vg, ky, keep, None, nlon_bins, nlat_bins,
        Thresholds(amp_min, amp_max, speed_min, speed_max, mwn_max), weight)
    lon_c, lat_c = _centers(nlon_bins, nlat_bins, lon.device)
    return WaveRayFlux(lon_centers=lon_c, lat_centers=lat_c, flux_u=fu,
                       flux_v=fv, amp_sum=asum, count=cnt)


def ensemble_flux_statistics(trajs, time_block=None, device=None, **kwargs):
    """Cellwise ensemble mean and spread of the flux maps across members.

    The pooled aggregation (concatenating member trajectories along the
    source axis, wrf_cli.load_ray_output) yields TOTAL maps over all
    members; this yields the member-statistic product instead: the
    ensemble-mean WRF map and the inter-member standard deviation (ddof=0)
    per cell. kwargs pass through to wave_ray_flux and must be identical
    for every member (same thresholds, bins, weight).

    Returns (mean, std) as WaveRayFlux tuples on the shared bin grid
    (std's lon/lat centers are the same tensors).

    time_block: bin each member in time blocks of this many output steps
    (wave_ray_flux_chunked on ``device``; bounded device memory for long
    histories).
    """
    trajs = list(trajs)
    if not trajs:
        raise ValueError("ensemble_flux_statistics needs at least 1 member")
    if time_block:
        members = [wave_ray_flux_chunked(t, time_block=time_block,
                                         device=device, **kwargs)
                   for t in trajs]
    else:
        members = [wave_ray_flux(t, **kwargs) for t in trajs]
    lon_c, lat_c = members[0].lon_centers, members[0].lat_centers

    def stats(name):
        # jnp.mean and jnp.var as XLA compiles them: the sums times the
        # reciprocal of the member count in the maps' dtype.
        x = [getattr(m, name) for m in members]
        x = torch.stack(x).to(torch.promote_types(x[0].dtype,
                                                  torch.float32))
        inv_n = float(torch.ones((), dtype=x.dtype)
                      / torch.tensor(len(members), dtype=x.dtype))
        mean = x.sum(0) * inv_n
        return mean, torch.sqrt(torch.square(x - mean).sum(0) * inv_n)

    per_map = [stats(n) for n in ("flux_u", "flux_v", "amp_sum", "count")]
    mean = WaveRayFlux(lon_c, lat_c, *(m for m, _ in per_map))
    std = WaveRayFlux(lon_c, lat_c, *(s for _, s in per_map))
    return mean, std


def _block(x, t0, t1, device) -> torch.Tensor:
    """Rows t0:t1 of a field (tensor, numpy or memmap) on ``device``."""
    return _tensor(x[t0:t1], device)


def wave_ray_flux_chunked(
    traj: RayTrajectories,
    time_block: int = 128,
    nlon_bins: int = 360,
    nlat_bins: int = 90,
    amp_min: float = 0.0,
    amp_max: float = float("inf"),
    speed_min: Optional[float] = None,
    speed_max: Optional[float] = None,
    mwn_max: Optional[float] = None,
    lon_range=None,
    lat_range=None,
    weight: str = "amp_cg",
    device=None,
) -> WaveRayFlux:
    """wave_ray_flux over time blocks: bounded device memory at any nt.

    Walks the time axis in ``time_block``-row blocks of a history that may
    live on the host (numpy, memmaps from trace_rays_chunked(stream_dir=...),
    CPU tensors) and copies each block to ``device`` (default: the
    trajectories' device if they are CUDA tensors, else the card). The two
    cross-time couplings are handled exactly: the continuous longitude
    unwrap is chained through a per-block carry, and the Fun2 region
    selection ("ray EVER enters the box") gets a first pass over the
    blocks (the region kernel on the card) accumulating the per-ray OR
    before the binning pass. Each block's maps, in the trajectories'
    dtype, are summed in float64, as the JAX package sums them. Result
    equals wave_ray_flux up to float summation order.
    """
    if time_block < 1:
        raise ValueError(f"time_block must be >= 1, got {time_block}")
    if device is None:
        device = (traj.lon.device if torch.is_tensor(traj.lon)
                  and traj.lon.is_cuda else "cuda")
    device = torch.device(device)
    nt = int(traj.lon.shape[0])
    bounds = list(range(0, nt, time_block)) + [nt]
    spans = [(a, b) for a, b in zip(bounds[:-1], bounds[1:]) if b > a]
    th = Thresholds(amp_min, amp_max, speed_min, speed_max, mwn_max)

    def rows(k, t0, t1):
        return _rows(_block(getattr(traj, k), t0, t1, device))

    keep = None
    if lon_range is not None and lat_range is not None:
        # First pass: only the three fields the box test reads.
        r = int(np.prod(traj.lon.shape[1:]))
        keep = torch.zeros(r, dtype=torch.bool, device=device)
        for t0, t1 in spans:
            keep = _region(rows("lon", t0, t1), rows("lat", t0, t1),
                           rows("amp", t0, t1), keep, lon_range, lat_range)

    maps = None
    carry = None
    for t0, t1 in spans:
        block = [rows(k, t0, t1) for k in ("lon", "lat", "amp", "ug", "vg")]
        ky = rows("ky", t0, t1) if mwn_max is not None else None
        bmaps, carry = _accumulate(*block, ky, keep, carry, nlon_bins,
                                   nlat_bins, th, weight)
        bmaps = torch.stack(bmaps).to(torch.float64)
        maps = bmaps if maps is None else maps + bmaps

    if maps is None:
        maps = torch.zeros((4, nlon_bins, nlat_bins), dtype=torch.float64,
                           device=device)
    lon_c, lat_c = _centers(nlon_bins, nlat_bins, device)
    return WaveRayFlux(lon_centers=lon_c, lat_centers=lat_c, flux_u=maps[0],
                       flux_v=maps[1], amp_sum=maps[2], count=maps[3])
