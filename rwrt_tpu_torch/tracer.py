"""Ray-tracing orchestration: seeding, initialization, integration, results.

Port of the dense adaptive path of ``rwrt_tpu/tracer.py``. ``trace_rays``
serves integrator='rk45', bound_mode='dense', state_dtype='compute' and
root_order='canonical', with or without pin_limit, on one device; every
other branch raises NotImplementedError naming its ROADMAP item.

The dense run (``_dense_run``: every group's integration, the kill cascade
and (ug, vg) at each bound) is one of the port's hand-written kernels,
``csrc/dense_run.cu``: on a CUDA state one launch runs the whole of it,
one thread per lane; on a CPU state the plain version ``_dense_run_plain``
runs. ``LAUNCHES`` counts its launches.

The ray batch is flattened to R = 3 * nsource * nzwn lanes in C order of
(root, source, zwn), so results reshape directly to (nt, 3, nsource, nzwn).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from rwrt_tpu_torch import kernels
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


def _dense_postpass(bg, hist, y, t, h, f, prev_lon, prev_lat, cut_off,
                    nan0):
    """Kill cascade + per-bound (ug, vg) over one group's dense-emitted
    history (G, 5, R).

    Exact with respect to per-bound termination: a kill at bound j only
    affects output at bounds >= j, and the killed lane's chunk-end carry is
    NaNed here. Frozen lanes (nan0: NaN state at chunk entry) bypass the
    cascade and keep their prefilled rows. Returns ((y, t, h, f, plon,
    plat) carry, (hist, ugs, vgs)).
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
        hist_k, ugs.reshape(g, r), vgs.reshape(g, r))


def initial_step_sizes(bg, y0, rtol, atol):
    """Per-ray initial h for the adaptive solver."""
    rhs_fn = ray_mod.RayRHS(bg)
    return rk45_mod.select_initial_step(rhs_fn, y0, rhs_fn(y0), rtol, atol)


#: Number of whole-run dense kernel launches (``csrc/dense_run.cu``) in
#: this process.
LAUNCHES = 0


class DenseRun(NamedTuple):
    """The dense adaptive run over every group of output bounds.

    ys (nt, 5, R) with y0 in row 0; ugs, vgs (nt, R) with ug0, vg0 in row
    0; lane_att (n_groups, R) int32, each group's step attempts per lane;
    trunc (R,) int32, the groups in which the max_iters backstop left the
    lane short of the group's last bound while alive; carry (y, t, h, f,
    plon, plat) after the last group. ys, ugs and vgs are views of
    (n_groups * G + 1)-row buffers whose padded rows are cut off.
    """

    ys: torch.Tensor
    ugs: torch.Tensor
    vgs: torch.Tensor
    lane_att: torch.Tensor
    trunc: torch.Tensor
    carry: Tuple[torch.Tensor, ...]


def _dense_run(bg, y0, ug0, vg0, h0, f0, bounds_g, n_bounds, cut_off, rtol,
               atol, min_step, max_iters=1_000_000, pin_limit=None,
               pin_mwn=None) -> DenseRun:
    """Integrate every group of output bounds with dense output, apply the
    kill cascade and sample (ug, vg) at each bound (the JAX package's
    grouped dense run: per group ``integrate_group_dense``, the truncation
    count, then ``_dense_postpass``).

    Args:
      bg: the static corner-packed background.
      y0 (5, R), f0 (5, R) = rhs(y0), h0 (R,): the run's entry state, at
        t = 0; ug0, vg0 (R,): row 0 of the (ug, vg) output.
      bounds_g: (n_groups, G) output times, padded rows repeating the last.
      n_bounds: the real bounds; the output keeps n_bounds + 1 rows.
      cut_off, rtol, atol, min_step, max_iters, pin_limit, pin_mwn: as for
        ``integrate_group_dense`` and the kill cascade.

    On a CUDA state one launch of ``csrc/dense_run.cu`` does it all, one
    thread per lane through every group; on a CPU state the plain version
    ``_dense_run_plain`` runs.
    """
    run = _dense_run_cuda if y0.is_cuda else _dense_run_plain
    return run(bg, y0, ug0, vg0, h0, f0, bounds_g, n_bounds, cut_off, rtol,
               atol, min_step, max_iters, pin_limit, pin_mwn)


def _dense_run_plain(bg, y0, ug0, vg0, h0, f0, bounds_g, n_bounds, cut_off,
                     rtol, atol, min_step, max_iters=1_000_000,
                     pin_limit=None, pin_mwn=None) -> DenseRun:
    """The plain PyTorch version (any device): group by group the plain
    dense loop with the plain RHS, the truncation count and
    ``_dense_postpass``, rows written into one preallocated output."""

    def rhs_fn(y, t=0.0):
        return ray_mod._rhs_core(bg, y, t, False)[0]

    n_groups, group = bounds_g.shape
    r = y0.shape[1]
    rows = n_groups * group + 1
    ys = torch.empty((rows, 5, r), dtype=y0.dtype, device=y0.device)
    ugs = torch.empty((rows, r), dtype=y0.dtype, device=y0.device)
    vgs = torch.empty_like(ugs)
    ys[0], ugs[0], vgs[0] = y0, ug0, vg0
    lane_att = torch.empty((n_groups, r), dtype=torch.int32,
                           device=y0.device)
    trunc = torch.zeros(r, dtype=torch.int32, device=y0.device)
    y, t, h, f, pl, pa = (y0, torch.zeros_like(y0[0]), h0, f0, y0[S_LON],
                          y0[S_LAT])
    for g, bounds in enumerate(bounds_g):
        nan0 = torch.isnan(torch.mean(y, dim=0))
        hist, y2, t2, h2, f2, _, _, la, _, _ = (
            rk45_mod._integrate_group_dense_plain(
                rhs_fn, y, t, h, f, bounds, rtol, atol, min_step, max_iters,
                pin_limit, pin_mwn))
        # Counted at integration end, before the kill cascade reads a
        # truncated lane's unreached bounds as death.
        trunc += (t2 < bounds[-1]) & ~torch.isnan(y2[0])
        (y, t, h, f, pl, pa), (hist, gu, gv) = _dense_postpass(
            bg, hist, y2, t2, h2, f2, pl, pa, cut_off, nan0)
        sl = slice(1 + g * group, 1 + (g + 1) * group)
        ys[sl], ugs[sl], vgs[sl] = hist, gu, gv
        lane_att[g] = la
    nt = n_bounds + 1
    return DenseRun(ys[:nt], ugs[:nt], vgs[:nt], lane_att, trunc,
                    (y, t, h, f, pl, pa))


def _dense_run_cuda(bg, y0, ug0, vg0, h0, f0, bounds_g, n_bounds, cut_off,
                    rtol, atol, min_step, max_iters, pin_limit,
                    pin_mwn) -> DenseRun:
    """Launch the whole-run dense kernel once: one thread per lane walks
    every group and writes its rows straight into the output. Reads
    nothing back from the card."""
    global LAUNCHES
    dev, dt = y0.device, y0.dtype
    if y0.ndim != 2 or y0.shape[0] != 5:
        raise ValueError(f"y0 must be (5, R); got {tuple(y0.shape)}")
    if bounds_g.ndim != 2 or 0 in bounds_g.shape:
        raise ValueError("bounds_g must be a non-empty (n_groups, G) tensor")
    r = y0.shape[1]
    n_groups, group = bounds_g.shape
    if not 0 <= n_bounds <= n_groups * group:
        raise ValueError(f"n_bounds {n_bounds} outside [0, {n_groups * group}]")
    for name, x, shape in (("y0", y0, (5, r)), ("f0", f0, (5, r)),
                           ("h0", h0, (r,)), ("ug0", ug0, (r,)),
                           ("vg0", vg0, (r,)),
                           ("bounds_g", bounds_g, (n_groups, group))):
        kernels.check_tensor(x, name, device=dev, dtype=dt, shape=shape)
    packed = bg.fields
    kernels.check_tensor(packed, "fields", device=dev, dtype=dt)
    kernels.check_aligned(packed, "fields")
    if packed.ndim != 3 or packed.shape[-1] != 48 or bg.member_ids is not None:
        raise ValueError("the dense-run kernel needs a static corner-packed "
                         "(W, H, 48) background")
    rtol, atol, min_step, pin_limit, pin_mwn = rk45_mod._scalar_args(
        dt, rtol, atol, min_step, pin_limit, pin_mwn)
    cut_off = rk45_mod.as_scalar(cut_off, dt)

    rows = n_groups * group + 1
    ys = torch.empty((rows, 5, r), dtype=dt, device=dev)
    ugs = torch.empty((rows, r), dtype=dt, device=dev)
    vgs = torch.empty_like(ugs)
    lane_att = torch.empty((n_groups, r), dtype=torch.int32, device=dev)
    trunc = torch.empty(r, dtype=torch.int32, device=dev)
    # The carry, updated in place by the kernel.
    y, h, f = y0.clone(), h0.clone(), f0.clone()
    t = torch.zeros_like(h0)
    plon = torch.empty_like(h0)
    plat = torch.empty_like(h0)
    w, hh, _ = packed.shape
    kernels.launch(
        "rwrt_dense_run", dt, packed, w, hh, bg.lon0, bg.lat0, bg.dx, bg.dy,
        y, t, h, f, ug0, vg0, ys, ugs, vgs, lane_att, trunc, plon, plat,
        bounds_g, group, n_groups, r, cut_off, rtol, atol, min_step,
        int(max_iters), pin_limit, pin_mwn, kernels.stream(dev))
    LAUNCHES += 1
    nt = n_bounds + 1
    return DenseRun(ys[:nt], ugs[:nt], vgs[:nt], lane_att, trunc,
                    (y, t, h, f, plon, plat))


def padded_bounds(dt, nt, group, dtype, device):
    """The (n_groups, group) output times of a run of nt rows: bounds dt,
    2 dt, ..., padded to whole groups by repeating the final time, which
    finished rays cross at once (the extra rows are discarded)."""
    n_groups = -(-(nt - 1) // group)
    bounds = torch.arange(1, n_groups * group + 1, dtype=dtype,
                          device=device) * dt
    return torch.clamp(bounds, max=(nt - 1) * dt).reshape(n_groups, group)


def _run_rk45_grouped(bg, y0, ug0, vg0, dt, nt, cut_off, rtol, atol,
                      min_step, group: int = 8, pin_limit=None, pin_mwn=None,
                      max_iters: int = 1_000_000):
    """Adaptive run over groups of ``group`` output bounds (the JAX
    package's dense=True branch; exact mode is not ported yet): the set-up
    (initial steps, f0, padded bounds), then ``_dense_run``.

    Returns (ys, ugs, vgs, iters, nfev, trunc, lane_att): iters (n_groups,)
    the trips per group (max over lanes of its attempts), nfev = 6 * iters,
    ``trunc`` the lanes the max_iters backstop left short of a group's final
    bound while alive, summed over groups (the run's one host read), and
    lane_att (n_groups, R) the step attempts per group and lane."""
    h0 = initial_step_sizes(bg, y0, rtol, atol)
    f0 = ray_mod.RayRHS(bg)(y0, torch.zeros_like(y0[0]))
    bounds_g = padded_bounds(dt, nt, group, y0.dtype, y0.device)
    run = _dense_run(bg, y0, ug0, vg0, h0, f0, bounds_g, nt - 1, cut_off,
                     rtol, atol, min_step, max_iters, pin_limit, pin_mwn)
    iters = run.lane_att.amax(dim=1)
    return (run.ys, run.ugs, run.vgs, iters, 6 * iters,
            int(run.trunc.sum()), run.lane_att)


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
    stats: Optional[dict] = None,
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
      stats: optional dict; receives "lane_att", the (n_groups, R') int32
        step attempts per group of the R' integrated (compacted) lanes, on
        the run's device.
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
    ys, ugs, vgs, _, _, trunc, lane_att = _run_rk45_grouped(
        bg, y0, ug0, vg0, dt, nt, cut_off, rtol, atol, min_step,
        group=min(config.interval_batch, nt - 1), pin_limit=config.pin_limit,
        pin_mwn=None if config.pin_limit is None else config.pin_mwn,
    )
    _check_truncation(trunc)
    if stats is not None:
        stats["lane_att"] = lane_att

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
