"""Ray-tracing orchestration: seeding, initialization, integration, results.

Port of the dense adaptive path of ``rwrt_tpu/tracer.py``. ``trace_rays``
serves integrator='rk45', bound_mode='dense', state_dtype='compute' and
root_order='canonical', with or without pin_limit, on one device; every
other branch raises NotImplementedError naming its ROADMAP item.

The ray batch is flattened to R = 3 * nsource * nzwn lanes in C order of
(root, source, zwn), so results reshape directly to (nt, 3, nsource, nzwn).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from rwrt_tpu_torch.config import RunConfig
from rwrt_tpu_torch.constants import deg2rad, undef
from rwrt_tpu_torch.models import ray as ray_mod
from rwrt_tpu_torch.models.basic_state import BasicState
from rwrt_tpu_torch.models.ray import (Background, S_AMP, S_KX, S_KY, S_LAT,
                                       S_LON)
from rwrt_tpu_torch.ops import interp
from rwrt_tpu_torch.ops.cubic import solve_dispersion_cubic
from rwrt_tpu_torch.ops.groupvel import group_velocity
from rwrt_tpu_torch.solvers import rk45 as rk45_mod


class RayTrajectories(NamedTuple):
    """Trajectory output, shapes (nt, 3, nsource, nzwn); lon/lat in
    radians."""

    lon: torch.Tensor
    lat: torch.Tensor
    kx: torch.Tensor   # rzwn
    ky: torch.Tensor   # rmwn
    amp: torch.Tensor
    ug: torch.Tensor
    vg: torch.Tensor


def source_matrix(
    sw_lon: float, sw_lat: float, dlon: float, dlat: float, nnx: int, nny: int,
    dtype=np.float64,
) -> Tuple[np.ndarray, np.ndarray]:
    """Regular source grid from the SW corner, in radians: lon normalized
    mod 360, iterated x-fastest."""
    if sw_lat + (nny - 1) * dlat > 89.0:
        raise ValueError("source latitude out of -90~90 range!")
    ix = np.arange(nnx)
    iy = np.arange(nny)
    lon_deg = (sw_lon % 360.0 + ix[None, :] * dlon) % 360.0
    lat_deg = sw_lat + iy[:, None] * dlat
    lon = np.broadcast_to(lon_deg, (nny, nnx)).reshape(-1) * deg2rad
    lat = np.broadcast_to(lat_deg, (nny, nnx)).reshape(-1) * deg2rad
    return lon.astype(dtype), lat.astype(dtype)


def make_background(bs: BasicState, freq: float) -> Background:
    """The RHS's background: the hot 12-field slice, corner-packed so each
    evaluation reads ONE 48-value row per ray, and the grid scalars rounded
    to the fields' dtype."""
    dtype = bs.fields.dtype
    return Background(
        fields=interp.pack_corners(bs.fields[..., : interp.NUM_HOT])
        .contiguous(),
        lon0=rk45_mod.as_scalar(bs.lon[0], dtype),
        lat0=rk45_mod.as_scalar(bs.lat[0], dtype),
        dx=rk45_mod.as_scalar(bs.dx, dtype),
        dy=rk45_mod.as_scalar(bs.dy, dtype),
        freq=rk45_mod.as_scalar(freq, dtype),
        bg_t0=rk45_mod.as_scalar(bs.bg_t0, dtype),
        bg_dt=rk45_mod.as_scalar(bs.bg_dt, dtype),
    )


def initialize(
    bg: Background,
    source_lon: torch.Tensor,
    source_lat: torch.Tensor,
    zwn: torch.Tensor,
    root_order: str = "canonical",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Initial state for all 3*nsource*nzwn rays.

    Positions are the source points; the three meridional-wavenumber roots
    per (source, zwn) come from the dispersion cubic; amp = 1 where the root
    exists else NaN; initial (ug, vg) use the zero-invalid semantics.

    Returns y0 (5, R), ug0 (R,), vg0 (R,).
    """
    if root_order == "fortran":
        raise NotImplementedError(
            "root_order='fortran' is not ported yet (ROADMAP Queue 1 "
            "item 15)")
    if root_order != "canonical":
        raise ValueError(f"unknown root_order {root_order!r}")
    nsource = source_lon.shape[0]
    nzwn = zwn.shape[0]

    f = ray_mod.sample_bg(bg, source_lon, source_lat, 0.0)
    fmu, fmv = f[interp.M_U], f[interp.M_V]
    fmqx, fmqy = f[interp.M_QX], f[interp.M_QY]

    roots, _ = solve_dispersion_cubic(
        fmu[:, None], fmv[:, None], fmqx[:, None], fmqy[:, None],
        bg.freq, zwn[None, :],
    )  # (nsource, nzwn, 3)
    mwn = roots.permute(2, 0, 1)  # (3, nsource, nzwn)

    shape = (3, nsource, nzwn)
    lon0 = source_lon[None, :, None].expand(shape)
    lat0 = source_lat[None, :, None].expand(shape)
    kx0 = zwn[None, None, :].expand(shape)
    amp0 = torch.where(torch.isnan(mwn), torch.full_like(mwn, undef),
                       torch.ones_like(mwn))

    ug0, vg0 = group_velocity(
        fmu[None, :, None], fmv[None, :, None],
        fmqx[None, :, None], fmqy[None, :, None],
        kx0, mwn, zero_invalid=True,
    )

    y0 = torch.stack([
        lon0.reshape(-1), lat0.reshape(-1), kx0.reshape(-1),
        mwn.reshape(-1), amp0.reshape(-1),
    ]).to(bg.fields.dtype)
    return y0, ug0.reshape(-1), vg0.reshape(-1)


def _dense_postpass(bg, hist, y, t, h, f, prev_lon, prev_lat, bounds,
                    cut_off, nan0, iters, nfev, lane_att):
    """Kill cascade + per-bound (ug, vg) over dense-emitted history.

    Exact with respect to per-bound termination: a kill at bound j only
    affects output at bounds >= j, and the killed lane's chunk-end carry is
    NaNed here. Frozen lanes (nan0: NaN state at chunk entry) bypass the
    cascade and keep their prefilled rows.
    """
    frozen = nan0
    plon, plat, alive = prev_lon, prev_lat, ~nan0
    nan = torch.full_like(hist[0], float("nan"))
    rows = []
    for j in range(hist.shape[0]):
        st = hist[j]
        dead = ((~alive) | ray_mod.kill_mask(st, plon, plat, cut_off)
                | torch.isnan(st[S_LON])) & ~frozen
        out = torch.where(dead[None, :], nan, st)
        alive = alive & ~dead
        plon = torch.where(alive, out[S_LON], plon)
        plat = torch.where(alive, out[S_LAT], plat)
        rows.append(out)
    hist_k = torch.stack(rows)

    # Per-bound group velocity over all (G * R) saved states in one call:
    # the static background makes the bound time irrelevant to the sample.
    g, _, r = hist_k.shape
    flat = hist_k.permute(1, 0, 2).reshape(5, g * r)
    ugs, vgs = ray_mod.group_velocity_at(
        bg, flat[S_LON], flat[S_LAT], flat[S_KX], flat[S_KY])

    y_carry = torch.where((alive | frozen)[None, :], y,
                          torch.full_like(y, float("nan")))
    return (y_carry, t, h, f, plon, plat), (
        hist_k, ugs.reshape(g, r), vgs.reshape(g, r), iters, nfev, lane_att)


def initial_step_sizes(bg, y0, rtol, atol):
    """Per-ray initial h for the adaptive solver."""
    rhs_fn = ray_mod.RayRHS(bg)
    return rk45_mod.select_initial_step(rhs_fn, y0, rhs_fn(y0), rtol, atol)


def _run_rk45_grouped(bg, y0, ug0, vg0, dt, nt, cut_off, rtol, atol,
                      min_step, group: int = 8, pin_limit=None, pin_mwn=None,
                      max_iters: int = 1_000_000):
    """Adaptive run over groups of ``group`` output bounds, each integrated
    by ``integrate_group_dense`` and post-passed by ``_dense_postpass`` (the
    JAX package's dense=True branch; exact mode is not ported yet).
    Returns (ys, ugs, vgs, iters, nfev, trunc); ``trunc`` counts lanes the
    max_iters backstop left short of a group's final bound while alive."""
    rhs_fn = ray_mod.RayRHS(bg)
    h0 = initial_step_sizes(bg, y0, rtol, atol)
    t0 = torch.zeros_like(y0[0])
    f0 = rhs_fn(y0, t0)

    n_bounds = nt - 1
    n_groups = -(-n_bounds // group)
    # Padded bounds repeat the final time: finished rays cross them at once
    # and the extra slots are discarded.
    padded = n_groups * group
    bounds_all = torch.arange(1, padded + 1, dtype=y0.dtype,
                              device=y0.device) * dt
    bounds_all = torch.clamp(bounds_all, max=(nt - 1) * dt)
    bounds_g = bounds_all.reshape(n_groups, group)

    y, t, h, f, pl, pa = y0, t0, h0, f0, y0[S_LON], y0[S_LAT]
    hists, ugss, vgss, iters, nfev, truncs = [], [], [], [], [], []
    for bounds in bounds_g:
        nan0 = torch.isnan(torch.mean(y, dim=0))
        hist, y2, t2, h2, f2, it, nf, la, _, _ = (
            rk45_mod.integrate_group_dense(
                rhs_fn, y, t, h, f, bounds, rtol, atol, min_step,
                max_iters=max_iters, pin_limit=pin_limit, pin_mwn=pin_mwn))
        # Counted at integration end, before the kill cascade reads a
        # truncated lane's unreached bounds as death; read on the host once,
        # after the last group, so no group waits for the card.
        truncs.append(torch.sum((t2 < bounds[-1]) & ~torch.isnan(y2[0])))
        (y, t, h, f, pl, pa), (hist, ugs, vgs, _, _, _) = _dense_postpass(
            bg, hist, y2, t2, h2, f2, pl, pa, bounds, cut_off, nan0,
            it, nf, la)
        hists.append(hist)
        ugss.append(ugs)
        vgss.append(vgs)
        iters.append(it)
        nfev.append(nf)
    ys = torch.cat(hists)[:n_bounds]
    ugs = torch.cat(ugss)[:n_bounds]
    vgs = torch.cat(vgss)[:n_bounds]
    ys = torch.cat([y0[None], ys], dim=0)
    ugs = torch.cat([ug0[None], ugs], dim=0)
    vgs = torch.cat([vg0[None], vgs], dim=0)
    return ys, ugs, vgs, iters, nfev, int(torch.stack(truncs).sum())


class MaxItersTruncation(RuntimeError):
    """The adaptive loop's max_iters backstop cut lanes off short of their
    output bounds: the emitted history would be silently frozen mid-interval
    for those lanes, so the fused runner refuses to return it. Arm the
    straggler pin-kill (RunConfig.pin_limit, pin_mwn=0)."""


def _check_truncation(trunc):
    n = int(np.asarray(trunc).sum())
    if n:
        raise MaxItersTruncation(
            f"adaptive integration hit the max_iters backstop with {n} "
            "unfinished lane-group(s); history would be silently frozen "
            "mid-interval. Arm the straggler pin-kill (pin_limit, "
            "pin_mwn=0)."
        )


def compact_lane_indices(born: np.ndarray):
    """Lane index set for rootless compaction, or None to skip.

    Keeps the born lanes plus enough rootless lanes to pad the count to a
    multiple of 8 (the JAX package's alignment rule, kept so both packages
    integrate the same lane set). Skips when fewer than 8 lanes would be
    saved.
    """
    born = np.asarray(born)
    n_rootless = int((~born).sum())
    if n_rootless < 8 or not born.any():
        return None
    idx = np.where(born)[0]
    pad = (-idx.size) % 8
    if pad:
        idx = np.concatenate([idx, np.where(~born)[0][:pad]])
    return idx


def _unsupported(config: RunConfig, mesh, initial_state):
    """The branches of the JAX trace_rays this port does not serve yet."""
    if config.integrator != "rk45":
        return "integrator='rk4' (ROADMAP Queue 1 item 10)"
    if config.bound_mode != "dense":
        return "bound_mode='exact' (ROADMAP Queue 1 item 11)"
    if mesh is not None:
        return "a device mesh (ROADMAP Slice 6, multi-GPU)"
    if config.state_dtype != "compute":
        return "state_dtype='float64' (ROADMAP Queue 1 item 12)"
    if config.root_order != "canonical":
        return "root_order='fortran' (ROADMAP Queue 1 item 15)"
    if initial_state is not None:
        return "initial_state (ROADMAP Slice 3, drivers and I/O)"
    return None


def trace_rays(
    bs: BasicState,
    config: RunConfig,
    source_lon: Optional[np.ndarray] = None,
    source_lat: Optional[np.ndarray] = None,
    mesh=None,
    initial_state=None,
    auto_chunk_bytes: Optional[int] = 2 << 30,
) -> RayTrajectories:
    """Run the dense adaptive ray-tracing pipeline on ``bs``'s device.

    Args:
      bs: prepared basic state (its device and dtype are the run's).
      config: run configuration.
      source_lon/source_lat: optional explicit source arrays in RADIANS;
        default: the config's regular source matrix.
      mesh, initial_state: not ported yet; must be None.
      auto_chunk_bytes: past this estimate of the (nt, 7, R) history the
        JAX package reroutes to its chunked driver; the port raises there
        until that driver is ported. None disables the check.
    """
    config.validate()
    why = _unsupported(config, mesh, initial_state)
    if why is not None:
        raise NotImplementedError(f"trace_rays does not serve {why} yet")
    dtype = bs.fields.dtype
    device = bs.fields.device
    if auto_chunk_bytes is not None:
        n_lanes = 3 * (config.nsource if source_lon is None
                       else np.asarray(source_lon).shape[0]) * config.nzwn
        itemsize = torch.empty((), dtype=dtype).element_size()
        est = 2 * config.nt * n_lanes * 7 * itemsize
        if est > auto_chunk_bytes:
            raise NotImplementedError(
                f"the history estimate ({est} B) exceeds auto_chunk_bytes "
                f"({auto_chunk_bytes} B), where the JAX package reroutes to "
                "its chunked driver, which is not ported yet (ROADMAP Queue "
                "1 item 8)")
    if source_lon is None:
        source_lon, source_lat = source_matrix(
            config.sw_lon, config.sw_lat, config.dlon, config.dlat,
            config.nnx, config.nny,
        )

    def to_dev(a):
        return torch.as_tensor(np.asarray(a)).to(device=device, dtype=dtype)

    source_lon = to_dev(source_lon)
    source_lat = to_dev(source_lat)
    zwn = to_dev(config.zwn_array())

    bg = make_background(bs, config.freq)
    y0, ug0, vg0 = initialize(bg, source_lon, source_lat, zwn,
                              config.root_order)

    n_rays = y0.shape[1]
    y0_full, ug0_full, vg0_full = y0, ug0, vg0
    take = None
    if config.compact_rootless:
        idx = compact_lane_indices(torch.isfinite(y0[4]).cpu().numpy())
        if idx is not None:
            take = torch.as_tensor(idx, device=device)
            y0 = y0.index_select(1, take).contiguous()
            ug0 = ug0.index_select(0, take)
            vg0 = vg0.index_select(0, take)
    n_lanes = y0.shape[1]

    nt = config.nt
    dt = rk45_mod.as_scalar(config.tstep, dtype)
    cut_off = rk45_mod.as_scalar(config.cut_off_rad, dtype)
    min_step = min(config.min_step_factor * config.tstep,
                   config.tstep * 1e-3)
    rtol = rk45_mod.validate_tol(config.rtol, dtype)
    atol = rk45_mod.as_scalar(config.atol, dtype)
    min_step = rk45_mod.as_scalar(min_step, dtype)
    ys, ugs, vgs, _, _, trunc = _run_rk45_grouped(
        bg, y0, ug0, vg0, dt, nt, cut_off, rtol, atol, min_step,
        group=min(config.interval_batch, nt - 1), pin_limit=config.pin_limit,
        pin_mwn=None if config.pin_limit is None else config.pin_mwn,
    )
    _check_truncation(trunc)

    if take is not None:
        # Rootless lanes are frozen at their seed state (finite lon/lat/kx,
        # NaN ky/amp); their (ug, vg) are NaN beyond step 0.
        ys_f = y0_full[None].expand((nt,) + tuple(y0_full.shape)).clone()
        ys_f[..., take] = ys[..., :n_lanes]
        ugs_f = torch.full((nt, n_rays), float("nan"), dtype=dtype,
                           device=device)
        vgs_f = ugs_f.clone()
        ugs_f[0] = ug0_full
        vgs_f[0] = vg0_full
        ugs_f[:, take] = ugs[:, :n_lanes]
        vgs_f[:, take] = vgs[:, :n_lanes]
        ys, ugs, vgs = ys_f, ugs_f, vgs_f

    nsource = source_lon.shape[0]
    out_shape = (nt, 3, nsource, len(config.zwn))

    def reshape(a):
        return a[..., :n_rays].reshape(out_shape)

    return _traj_from(ys, ugs, vgs, reshape)


def _traj_from(ys, ugs, vgs, reshape):
    return RayTrajectories(
        lon=reshape(ys[:, S_LON]),
        lat=reshape(ys[:, S_LAT]),
        kx=reshape(ys[:, S_KX]),
        ky=reshape(ys[:, S_KY]),
        amp=reshape(ys[:, S_AMP]),
        ug=reshape(ugs),
        vg=reshape(vgs),
    )
