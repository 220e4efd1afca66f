"""Ray-tracing orchestration: seeding, initialization, integration, results.

Port of ``rwrt_tpu/tracer.py``. ``trace_rays`` serves three branches, on
one device or a mesh of them, with root_order 'canonical' or 'fortran'
(the reference's slot layout, from np.roots on the host at
initialization), from the computed seeds or a given ``initial_state``, in
state_dtype 'compute' and in 'float64' (mixed precision: a float64 state,
stage accumulation and controller over float32 sampling and RHS algebra
when cal_dtype is float32; a no-op when it is float64):

- integrator='rk4' (``_run_rk4``), the library default;
- integrator='rk45', bound_mode='exact' (``_run_rk45_grouped`` over
  ``_exact_run``, or ``_run_rk45`` when interval_batch is 1 or nt <= 2);
- integrator='rk45', bound_mode='dense', with or without pin_limit
  (``_run_rk45_grouped`` over ``_dense_run``).

Every branch serves a static or a time-varying background
(``models.basic_state.prepare_time_varying``: each sample lerps the frames
at the lane's own time). ``trace_rays_ensemble`` runs several members in
one run, their lanes flattened over one stacked background with a per-lane
member map.

A run whose history would pass ``auto_chunk_bytes`` on the device goes
through the chunked driver (``utils/checkpoint.py``), one launch of the
same kernel per chunk. Over a device mesh (``parallel/sharding.py``) the
lanes split into one shard per mesh entry and each shard is the same run
over its lanes (``_run_sharded``): one launch per shard, rows bitwise those
of the run without a mesh.

Each branch's run is one of the port's hand-written kernels: on a CUDA
state one launch runs the whole of it; on a CPU state its plain version
runs. ``_run_rk4``: ``csrc/rk4_run.cu``, plain ``solvers/rk4.trace``
(``RK4_LAUNCHES``); ``_exact_run``: ``csrc/exact_run.cu``, plain
``_exact_run_plain`` (``EXACT_LAUNCHES``); ``_dense_run``:
``csrc/dense_run.cu``, plain ``_dense_run_plain`` (``LAUNCHES``). The
dense kernel runs one thread per lane and repacks the live lanes into
full warps inside the launch (``DENSE_SCHEDULE``, ``dense_grid``); the
RK4 and exact kernels one thread, or a team of 8 threads, per lane, as
``rk4_instance`` and
``solvers/rk45.exact_instance`` choose from the lane count, and the exact
kernel with a float64 state repacks its live lanes (or teams) as the dense
one does (``EXACT_SCHEDULE``, ``exact_grid``). Each kernel
has a mixed instance (``_mix``, ``kernels.launch``) beside its float32
and float64 ones, which the wrappers take for a float64 state over a
float32 background, and a time instance of each (``_time``), which they
take for a time-varying or ensemble background
(``models.ray.kernel_background``). Before an adaptive run's one launch,
its entry stage (f0 and Hairer's initial step) is one launch of
``csrc/entry.cu`` (``entry_stage``, ``ENTRY_LAUNCHES``). Before either,
the seeds (``initialize``: the roots of the dispersion cubic and the
initial group velocity at every source and zwn) are one launch of
``csrc/seed.cu`` (``SEED_LAUNCHES``), for all of an ensemble's members.

The ray batch is flattened to R = 3 * nsource * nzwn lanes in C order of
(root, source, zwn), so results reshape directly to (nt, 3, nsource, nzwn).
"""

from __future__ import annotations

import functools
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
from rwrt_tpu_torch.parallel import sharding
from rwrt_tpu_torch.solvers import rk4 as rk4_mod
from rwrt_tpu_torch.solvers import rk45 as rk45_mod
from rwrt_tpu_torch.utils import observability


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
        lon0=rk45_mod.as_scalar(_read(bs.lon[0]), dtype),
        lat0=rk45_mod.as_scalar(_read(bs.lat[0]), dtype),
        dx=rk45_mod.as_scalar(bs.dx, dtype),
        dy=rk45_mod.as_scalar(bs.dy, dtype),
        freq=rk45_mod.as_scalar(freq, dtype),
        bg_t0=rk45_mod.as_scalar(bs.bg_t0, dtype),
        bg_dt=rk45_mod.as_scalar(bs.bg_dt, dtype),
    )


#: Seed-stage kernel launches (``csrc/seed.cu``) and ``initialize`` calls,
#: plain or kernel, in this process.
SEED_LAUNCHES = 0
SEED_CALLS = 0


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

    root_order: 'canonical' (sorted; see ops/cubic.py) or 'fortran': the
    reference's exact slot layout, from np.roots and the slot shuffle on
    the host (``ops.cubic_host.initial_roots_reference_order``), on the
    background sampled in its own dtype and widened to float64. The layout
    depends on LAPACK's eigenvalue order, which the device solver cannot
    reproduce. One host read and a host solve, once per run.

    An ensemble background (``member_ids`` over member-major lanes, R =
    3 * nsource * nzwn a member, as ``trace_rays_ensemble`` lays them)
    seeds each member's R lanes from the stack its lanes map to.

    A call whose background is on the card takes one launch of
    ``csrc/seed.cu`` (``SEED_LAUNCHES``) where ``_seed_kernel_takes`` it:
    canonical order and no input that carries a gradient. The launch
    raises ValueError unless the sources and zwn are of the background's
    dtype and device. Every other call (a CPU background, a gradient
    through the seeds, root_order='fortran') takes the plain composition
    (``_initialize_plain``), which gives the same bits. ``SEED_CALLS``
    counts every call.

    Returns y0 (5, R), ug0 (R,), vg0 (R,) (R summed over the members).
    """
    global SEED_CALLS
    if root_order not in ("canonical", "fortran"):
        raise ValueError(f"unknown root_order {root_order!r}")
    SEED_CALLS += 1
    inputs = (source_lon, source_lat, zwn)
    if bg.fields.is_cuda and _seed_kernel_takes(bg, inputs, root_order):
        return _initialize_cuda(bg, *inputs)
    return _initialize_plain(bg, *inputs, root_order)


def _seed_kernel_takes(bg: Background, inputs, root_order: str) -> bool:
    """Whether ``initialize`` on the card launches the seed kernel: root
    order 'canonical' and, while grad mode is on, no input (the
    background's stack among them) that requires grad."""
    if root_order != "canonical":
        return False
    return not (torch.is_grad_enabled() and any(
        t.requires_grad for t in (bg.fields, *inputs)))


def _initialize_cuda(bg, source_lon, source_lat, zwn):
    """Launch the seed kernel: one thread per (member, source, zwn) point
    samples the background at its source, solves the cubic and writes its
    three lanes. A static background takes the static instance; any other
    the time instance, a time-varying stack at t = 0, an ensemble's stacks
    by its member map. Raises ValueError unless the sources and zwn are
    vectors of the background's dtype and device."""
    global SEED_LAUNCHES
    dev, dtype = bg.fields.device, bg.fields.dtype
    source_lon, source_lat, zwn = (
        x.contiguous() for x in (source_lon, source_lat, zwn))
    nsource, nzwn = source_lon.shape[0], zwn.shape[0]
    for x, name, n in ((source_lon, "source_lon", nsource),
                       (source_lat, "source_lat", nsource),
                       (zwn, "zwn", nzwn)):
        kernels.check_tensor(x, name, device=dev, dtype=dtype, shape=(n,))
    r = 3 * nsource * nzwn
    lanes = r if bg.member_ids is None else bg.member_ids.shape[0]
    if r and lanes % r:
        raise ValueError(f"member_ids ({lanes} lanes) is not whole members "
                         f"of {r} lanes")
    variant, bg_args = ray_mod.kernel_background(bg, dev, dtype, lanes)
    out = torch.empty((7, lanes), dtype=dtype, device=dev)
    kernels.launch(f"rwrt_seed{variant}", dtype, *bg_args,
                   source_lon, source_lat, zwn, nsource, nzwn, lanes // max(r, 1),
                   float(bg.freq), out, out[5], out[6], kernels.stream(dev))
    SEED_LAUNCHES += 1
    return out[:5], out[5], out[6]


def _initialize_plain(bg, source_lon, source_lat, zwn,
                      root_order="canonical"):
    """The plain version of ``initialize`` (any device): the sample, the
    roots (``ops/cubic``), amp and (ug, vg) (``ops/groupvel``) as PyTorch
    ops, differentiable throughout; an ensemble's members in turn, each
    member's sources sampled by the map at their root-0, zwn-0 lanes."""
    if bg.member_ids is None:
        return _seed_plain(bg, source_lon, source_lat, zwn, root_order)
    nsource, nzwn = source_lon.shape[0], zwn.shape[0]
    r = 3 * nsource * nzwn
    parts = [_seed_plain(
        bg._replace(member_ids=bg.member_ids[i:i + nsource * nzwn:nzwn]),
        source_lon, source_lat, zwn, root_order)
        for i in range(0, bg.member_ids.shape[0], max(r, 1))]
    return tuple(torch.cat(x, dim=-1) for x in zip(*parts))


def _seed_plain(bg, source_lon, source_lat, zwn, root_order):
    """``_initialize_plain`` for one member (``bg.member_ids`` None, or the
    (nsource,) member of each source)."""
    nsource = source_lon.shape[0]
    nzwn = zwn.shape[0]

    f = ray_mod.sample_bg(bg, source_lon, source_lat, 0.0)
    fmu, fmv = f[interp.M_U], f[interp.M_V]
    fmqx, fmqy = f[interp.M_QX], f[interp.M_QY]

    if root_order == "fortran":
        from rwrt_tpu_torch.ops.cubic_host import (
            initial_roots_reference_order)

        roots = _upload(initial_roots_reference_order(
            *(_read(x) for x in (fmu, fmv, fmqx, fmqy)), float(bg.freq),
            _read(zwn)), bg.fields.device, bg.fields.dtype)
    else:
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
                    nan0, bounds=None):
    """Kill cascade + per-bound (ug, vg) over one group's dense-emitted
    history (G, 5, R), each bound's (ug, vg) sampled at its time
    (``bounds``, (G,); None: at time 0, which a static background does not
    read).

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

    # Per-bound group velocity over all (G * R) saved states in one call,
    # each state at its bound's time (an ensemble's member map is tiled).
    g, _, r = hist_k.shape
    flat = hist_k.permute(1, 0, 2).reshape(5, g * r)
    times = 0.0 if bounds is None else bounds[:, None].expand(g, r).reshape(-1)
    ugs, vgs = ray_mod.group_velocity_at(
        bg, flat[S_LON], flat[S_LAT], flat[S_KX], flat[S_KY], times)

    y_carry = torch.where((alive | frozen)[None, :], y,
                          torch.full_like(y, float("nan")))
    return (y_carry, t, h, f, plon, plat), (
        hist_k, ugs.reshape(g, r), vgs.reshape(g, r))


#: Entry-stage kernel launches (``csrc/entry.cu``) in this process.
ENTRY_LAUNCHES = 0


def entry_stage(bg, y0, t0, rtol, atol):
    """The adaptive runs' entry stage at time ``t0`` (a Python float or a
    per-lane tensor of the state's dtype): (h0 (R,), f0 (5, R)), the
    initial step (``rk45.select_initial_step``) and the FSAL stage
    rhs(y0, t0), f0 in the background's dtype. On a CUDA state one launch
    of ``csrc/entry.cu``; on a CPU state the plain composition
    (``_entry_stage_plain``)."""
    run = _entry_stage_cuda if y0.is_cuda else _entry_stage_plain
    return run(bg, y0, t0, rtol, atol)


def _entry_stage_plain(bg, y0, t0, rtol, atol):
    """The plain version (any device): f0 = rhs(y0, t0) and
    ``select_initial_step`` over the plain RHS ``ray._rhs_core``."""

    def rhs_fn(yy, tt=0.0):
        return ray_mod._rhs_core(bg, yy, tt, False)[0]

    f0 = rhs_fn(y0, t0)
    return rk45_mod.select_initial_step(rhs_fn, y0, f0, rtol, atol, t0), f0


def _entry_stage_cuda(bg, y0, t0, rtol, atol):
    """Launch the entry-stage kernel: one thread per lane computes f0 and
    the initial step in registers. A static background takes the static
    instance, which forms no time; any other the time instance, with the
    lanes' times."""
    global ENTRY_LAUNCHES
    key = kernels.state_key(y0, bg.fields)
    if y0.ndim != 2 or y0.shape[0] != 5:
        raise ValueError(f"y0 must be (5, R); got {tuple(y0.shape)}")
    y0 = y0.contiguous()
    dev, sdt = y0.device, y0.dtype
    r = y0.shape[1]
    variant, bg_args = ray_mod.kernel_background(bg, dev, key[1], r)
    extra = ()
    if variant:
        if torch.is_tensor(t0):
            t0 = (t0.expand(r) if t0.ndim == 0 else t0).contiguous()
            kernels.check_tensor(t0, "t0", device=dev, dtype=sdt,
                                 shape=(r,))
        else:
            t0 = torch.full((r,), float(t0), dtype=sdt, device=dev)
        extra = (t0,)
    f0 = torch.empty((5, r), dtype=key[1], device=dev)
    h0 = torch.empty(r, dtype=sdt, device=dev)
    kernels.launch(f"rwrt_entry{variant}", key, *bg_args, y0, *extra, r,
                   float(rtol), float(atol), f0, h0, kernels.stream(dev))
    ENTRY_LAUNCHES += 1
    return h0, f0


def initial_step_sizes(bg, y0, rtol, atol):
    """Per-ray initial h for the adaptive solver (the entry stage's h0 at
    t = 0)."""
    return entry_stage(bg, y0, 0.0, rtol, atol)[0]


#: Whole-run kernel launches in this process: the dense run
#: (``csrc/dense_run.cu``), the RK4 run (``csrc/rk4_run.cu``) and the exact
#: run (``csrc/exact_run.cu``).
LAUNCHES = 0
RK4_LAUNCHES = 0
EXACT_LAUNCHES = 0

#: Points on ``trace_rays``' and ``trace_rays_ensemble``'s path where the
#: host waits for the card, in this process: each copy of host data to a
#: device tensor (``_upload``) and each read of a device tensor's value
#: (``_read``). A CPU state counts none; the chunked driver's own copies
#: (``utils/checkpoint.py``) are not counted.
HOST_SYNCS = 0


def _host_sync(device) -> None:
    global HOST_SYNCS
    if device.type != "cpu":
        HOST_SYNCS += 1


def _upload(a, device, dtype=None) -> torch.Tensor:
    """``a`` (an array, or a tensor) as a tensor on ``device``; a copy of
    host data to a device counts in ``HOST_SYNCS``."""
    t = a if torch.is_tensor(a) else torch.as_tensor(np.asarray(a))
    if t.device.type == "cpu":
        _host_sync(device)
    return t.to(device=device, dtype=dtype)


def _read(t: torch.Tensor) -> torch.Tensor:
    """``t`` on the host; a read of a device tensor counts in
    ``HOST_SYNCS``."""
    _host_sync(t.device)
    return t.cpu()


#: The whole-run dense kernel's repack schedule (every, trigger) by the
#: launch's (state, field) dtypes: each block repacks its live lanes after
#: at most ``every`` loop iterations (trips or group changes) of each, and
#: as soon as ``trigger`` lanes have left it since the last repack (None:
#: never sooner). Measured on an NVIDIA H100 (PERF.md section 6): a
#: float32 trip issues cheaply, so a repack's barriers cost more than the
#: warps it frees, while float64 arithmetic is what a warp's idle lanes
#: waste.
DENSE_SCHEDULE = {
    (torch.float32, torch.float32): (128, None),
    (torch.float64, torch.float32): (1000, 32),
    (torch.float64, torch.float64): (1000, 1),
}


def dense_grid(key, variant: str = "") -> tuple:
    """(blocks, threads a block) of the whole-run dense kernel's
    persistent grid on the current card: the blocks it keeps resident at
    once, from the CUDA occupancy calculator (``rwrt_dense_resident``);
    ``key`` the (state, field) dtype pair, ``variant`` "" or "_time".
    Read once per process and card."""
    return _dense_grid(torch.cuda.current_device(), tuple(key), variant)


@functools.cache
def _dense_grid(card: int, key, variant: str) -> tuple:
    """``dense_grid`` on card index ``card``, the current one."""
    out = torch.zeros(2, dtype=torch.int32)
    kernels.launch(f"rwrt_dense_resident{variant}", key, out)
    return int(out[0]), int(out[1])


#: The whole-run exact kernel's repack schedule (every, trigger) by the
#: launch's (state, field) dtypes, as ``DENSE_SCHEDULE``'s; None: the
#: launch-order kernel, each lane (or team) to its end with no persistent
#: grid (float32, whose README runs sit within 10 % of their chain floor
#: in launch order). A float64 state repacks on a persistent grid
#: (``exact_grid``). Measured on an NVIDIA H100 (PERF.md section 6).
EXACT_SCHEDULE = {
    (torch.float32, torch.float32): None,
    (torch.float64, torch.float32): (1000, 1),
    (torch.float64, torch.float64): (1000, 1),
}


def exact_grid(key, variant: str = "", instance: str = "lane") -> tuple:
    """(blocks, threads a block) of the whole-run exact kernel's grid on
    the current card for ``instance``: with a float64 state the persistent
    grid of the blocks it keeps resident (a team instance holds threads /
    8 lanes a block); in float32 the launch-order kernel's resident blocks
    of 128. From the CUDA occupancy calculator (``rwrt_exact_grid``); read
    once per process and card."""
    return _exact_grid(torch.cuda.current_device(), tuple(key), variant,
                       instance)


@functools.cache
def _exact_grid(card: int, key, variant: str, instance: str) -> tuple:
    """``exact_grid`` on card index ``card``, the current one."""
    out = torch.zeros(2, dtype=torch.int32)
    kernels.launch(f"rwrt_exact_grid{variant}", key,
                   kernels.instance_id(instance), out)
    return int(out[0]), int(out[1])


def rk4_instance(r: int, dtype, variant: str = "") -> str:
    """The RK4 kernel's instance for a launch of ``r`` lanes on the card;
    ``dtype`` a torch dtype or a (state, field) pair, ``variant`` "" (a
    static background) or "_time" (``ray.kernel_background``): the team
    in the variant's window, ``kernels.RK4_TEAM_LANES``, where it fits the
    card's resident count."""
    return kernels.choose_instance(
        r, kernels.resident("rk4", kernels.TEAM, dtype, variant=variant),
        kernels.RK4_TEAM_LANES[variant])


class GroupedRun(NamedTuple):
    """An adaptive run over every group of output bounds, dense or exact.

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


def _run_buffers(y0, n_groups, group):
    """Outputs of a run over n_groups groups of ``group`` bounds: (ys, ugs,
    vgs) of n_groups * group + 1 empty rows, lane_att (n_groups, R) empty
    and trunc (R,) zeros."""
    r = y0.shape[1]
    rows = n_groups * group + 1
    ys = torch.empty((rows, 5, r), dtype=y0.dtype, device=y0.device)
    ugs = torch.empty((rows, r), dtype=y0.dtype, device=y0.device)
    lane_att = torch.empty((n_groups, r), dtype=torch.int32, device=y0.device)
    return (ys, ugs, torch.empty_like(ugs), lane_att,
            torch.zeros(r, dtype=torch.int32, device=y0.device))


def _check_run_args(bg, y0, ug0, vg0, h0, f0, bounds_g, n_bounds,
                    min_groups):
    """Raise unless a whole-run kernel takes these inputs: y0, h0 and the
    bounds in the state's dtype, f0 in the background's, ug0 and vg0 in
    either. Returns the launch's (state, field) dtype pair and
    ``ray.kernel_background``'s (variant, background arguments)."""
    dev, dt = y0.device, y0.dtype
    key = kernels.state_key(y0, bg.fields)
    if y0.ndim != 2 or y0.shape[0] != 5:
        raise ValueError(f"y0 must be (5, R); got {tuple(y0.shape)}")
    if (bounds_g.ndim != 2 or bounds_g.shape[1] < 1
            or bounds_g.shape[0] < min_groups):
        raise ValueError(f"bounds_g must be a (n_groups >= {min_groups}, "
                         "G >= 1) tensor")
    r = y0.shape[1]
    n_groups, group = bounds_g.shape
    if not 0 <= n_bounds <= n_groups * group:
        raise ValueError(f"n_bounds {n_bounds} outside [0, {n_groups * group}]")
    for name, x, shape in (("y0", y0, (5, r)), ("h0", h0, (r,)),
                           ("bounds_g", bounds_g, (n_groups, group))):
        kernels.check_tensor(x, name, device=dev, dtype=dt, shape=shape)
    kernels.check_tensor(f0, "f0", device=dev, dtype=key[1], shape=(5, r))
    for name, x in (("ug0", ug0), ("vg0", vg0)):
        kernels.check_tensor(x, name, device=dev, dtype=x.dtype, shape=(r,))
        if x.dtype not in key:
            raise ValueError(f"{name} has dtype {x.dtype}, expected one of "
                             f"{sorted(set(map(str, key)))}")
    return key, ray_mod.kernel_background(bg, dev, key[1], r)


def _dense_run(bg, y0, ug0, vg0, h0, f0, bounds_g, n_bounds, cut_off, rtol,
               atol, min_step, max_iters=1_000_000, pin_limit=None,
               pin_mwn=None, t0=None) -> GroupedRun:
    """Integrate every group of output bounds with dense output, apply the
    kill cascade and sample (ug, vg) at each bound (the JAX package's
    grouped dense run: per group ``integrate_group_dense``, the truncation
    count, then ``_dense_postpass``).

    Args:
      bg: the corner-packed background (static, time-varying or an
        ensemble's, ``make_background``).
      y0 (5, R), f0 (5, R) = rhs(y0), h0 (R,): the run's entry state;
        ug0, vg0 (R,): row 0 of the (ug, vg) output.
      bounds_g: (n_groups, G) output times, padded rows repeating the last.
      n_bounds: the real bounds; the output keeps n_bounds + 1 rows.
      cut_off, rtol, atol, min_step, max_iters, pin_limit, pin_mwn: as for
        ``integrate_group_dense`` and the kill cascade.
      t0: the lanes' entry times (R,) in the state's dtype; None: zeros.
        The kill test's last position starts at y0's, so a run from the
        carry of an earlier one is one chunk of the chunked driver
        (``utils/checkpoint.py``).

    On a CUDA state one launch of ``csrc/dense_run.cu`` does it all, each
    lane one thread's loop through every group, live lanes repacked into
    full warps as others finish; on a CPU state the plain version
    ``_dense_run_plain`` runs.
    """
    run = _dense_run_cuda if y0.is_cuda else _dense_run_plain
    return run(bg, y0, ug0, vg0, h0, f0, bounds_g, n_bounds, cut_off, rtol,
               atol, min_step, max_iters, pin_limit, pin_mwn, t0)


def _entry_time(t0, h0):
    """The lanes' entry times: ``t0``, or zeros like ``h0``."""
    if t0 is None:
        return torch.zeros_like(h0)
    kernels.check_tensor(t0, "t0", device=h0.device, dtype=h0.dtype,
                         shape=h0.shape)
    return t0


def _dense_run_plain(bg, y0, ug0, vg0, h0, f0, bounds_g, n_bounds, cut_off,
                     rtol, atol, min_step, max_iters=1_000_000,
                     pin_limit=None, pin_mwn=None, t0=None) -> GroupedRun:
    """The plain PyTorch version (any device): group by group the plain
    dense loop with the plain RHS, the truncation count and
    ``_dense_postpass``, rows written into one preallocated output."""

    def rhs_fn(y, t=0.0):
        return ray_mod._rhs_core(bg, y, t, False)[0]

    n_groups, group = bounds_g.shape
    ys, ugs, vgs, lane_att, trunc = _run_buffers(y0, n_groups, group)
    ys[0], ugs[0], vgs[0] = y0, ug0, vg0
    y, t, h, f, pl, pa = (y0, _entry_time(t0, h0), h0, f0, y0[S_LON],
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
            bg, hist, y2, t2, h2, f2, pl, pa, cut_off, nan0, bounds)
        sl = slice(1 + g * group, 1 + (g + 1) * group)
        ys[sl], ugs[sl], vgs[sl] = hist, gu, gv
        lane_att[g] = la
    nt = n_bounds + 1
    return GroupedRun(ys[:nt], ugs[:nt], vgs[:nt], lane_att, trunc,
                      (y, t, h, f, pl, pa))


def _dense_run_cuda(bg, y0, ug0, vg0, h0, f0, bounds_g, n_bounds, cut_off,
                    rtol, atol, min_step, max_iters, pin_limit,
                    pin_mwn, t0=None, *, _blocks=None, _repack=None,
                    _trigger=None) -> GroupedRun:
    """Launch the whole-run dense kernel once: each lane walks every group
    and writes its rows straight into the output; the blocks of a
    persistent grid (``dense_grid``) repack their live lanes on the
    schedule ``DENSE_SCHEDULE`` gives the dtypes, and take queued lanes
    into the freed threads. Reads nothing back from the card. A float64
    state over a float32 background takes the mixed instance; ug0 and vg0
    are widened to the state's dtype for row 0. A time-varying or ensemble
    background takes the time instance.

    ``_blocks`` (a grid of that many blocks, so that lanes outnumber the
    resident threads and the queue refills), ``_repack`` and ``_trigger``
    (another repack schedule) are for the card tests and the measurement
    scripts; none changes a bit of the output."""
    global LAUNCHES
    key, (variant, bg_args) = _check_run_args(bg, y0, ug0, vg0, h0, f0,
                                              bounds_g, n_bounds, 1)
    blocks = dense_grid(key, variant)[0] if _blocks is None else _blocks
    every, trigger = DENSE_SCHEDULE[key]
    every = every if _repack is None else _repack
    if _trigger is not None:
        trigger = _trigger
    elif trigger is None:
        trigger = 1 << 30  # no window ends early
    if min(int(blocks), int(every), int(trigger)) < 1:
        raise ValueError(f"_blocks ({blocks}), _repack ({every}) and "
                         f"_trigger ({trigger}) must be at least 1")
    dev, dt = y0.device, y0.dtype
    rtol, atol, min_step, pin_limit, pin_mwn = rk45_mod._scalar_args(
        dt, rtol, atol, min_step, pin_limit, pin_mwn)
    cut_off = rk45_mod.as_scalar(cut_off, dt)
    r = y0.shape[1]
    n_groups, group = bounds_g.shape
    ys, ugs, vgs, lane_att, trunc = _run_buffers(y0, n_groups, group)
    # The carry, updated in place by the kernel.
    y, h, f = y0.clone(), h0.clone(), f0.clone()
    t = _entry_time(t0, h0).clone()
    plon = torch.empty_like(h0)
    plat = torch.empty_like(h0)
    # The lane queue's counter, scratch for the kernel.
    queue = torch.zeros(1, dtype=torch.int32, device=dev)
    ug0, vg0 = ug0.to(dt), vg0.to(dt)
    kernels.launch(
        f"rwrt_dense_run{variant}", key, *bg_args, y, t, h, f, ug0, vg0, ys,
        ugs, vgs, lane_att, trunc, plon,
        plat, bounds_g, group, n_groups, r, cut_off, rtol, atol, min_step,
        int(max_iters), pin_limit, pin_mwn, int(blocks), queue, int(every),
        int(trigger), kernels.stream(dev))
    LAUNCHES += 1
    nt = n_bounds + 1
    return GroupedRun(ys[:nt], ugs[:nt], vgs[:nt], lane_att, trunc,
                      (y, t, h, f, plon, plat))


def _rk45_group_chunk(bg, y, t, h, f, prev_lon, prev_lat, bounds, cut_off,
                      rtol, atol, min_step, max_iters=1_000_000,
                      barrier=False):
    """One GROUP of output bounds in exact mode, plain PyTorch on every
    device (``solvers/rk45._integrate_group_plain`` with the plain RHS): the
    per-group unit of ``_exact_run_plain``. Numerically identical to
    ``_rk45_chunk`` over the same bounds where no lane's amp turns NaN
    inside the group; with ``barrier`` (one bound) also where one does.

    Returns ((y, t, h, f, prev_lon, prev_lat), (hist, ugs, vgs, iters,
    nfev, lane_att)), hist (G, 5, R), ugs and vgs (G, R).
    """

    def rhs_fn(yy, tt=0.0):
        return ray_mod._rhs_core(bg, yy, tt, False)[0]

    # In mixed precision the barrier path samples (ug, vg) at the saved
    # state in the state's dtype (``_rk45_chunk``), where the 7th stage
    # samples it rounded to the background's; the grouped path keeps the
    # stage's values (the JAX package's two paths differ so).
    gv_at_save = barrier and y.dtype != bg.fields.dtype

    def rhs_gv_fn(yy, tt=0.0):
        if gv_at_save:
            return (rhs_fn(yy, tt), *ray_mod.group_velocity_at(
                bg, yy[S_LON], yy[S_LAT], yy[S_KX], yy[S_KY], tt))
        dy, _, ug, vg = ray_mod._rhs_core(bg, yy, tt, True)
        return dy, ug, vg

    hist, y, t, h, f, prev_lon, prev_lat, iters, nfev, lane_att = (
        rk45_mod._integrate_group_plain(
            rhs_fn, rhs_gv_fn, y, t, h, f, bounds, prev_lon, prev_lat,
            cut_off, rtol, atol, min_step, max_iters,
            barrier=barrier)[:10])
    return (y, t, h, f, prev_lon, prev_lat), (
        hist[:, :5], hist[:, 5], hist[:, 6], iters, nfev, lane_att)


def _exact_run(bg, y0, ug0, vg0, h0, f0, bounds_g, n_bounds, cut_off, rtol,
               atol, min_step, max_iters=1_000_000,
               barrier=False, t0=None) -> GroupedRun:
    """Integrate every group of output bounds in exact mode (the JAX
    package's grouped exact run: per group ``_rk45_group_chunk``, then the
    truncation count). Arguments as ``_dense_run``'s (t0 too), without the
    pin-kill;
    bounds_g may have no group (a run of row 0 alone). With ``barrier`` a
    lane is walked as frozen (NaN amp, finite dynamics) only if it is so at
    a group's entry: with one bound per group, the barrier path's semantics
    (``_run_rk45``).

    On a CUDA state one launch of ``csrc/exact_run.cu`` does it all, one
    thread (or a team of threads, ``solvers/rk45.exact_instance``) per
    lane through every group, with a float64 state live lanes repacked
    into full warps as others finish; on a CPU state the plain version
    ``_exact_run_plain`` runs.
    """
    run = _exact_run_cuda if y0.is_cuda else _exact_run_plain
    return run(bg, y0, ug0, vg0, h0, f0, bounds_g, n_bounds, cut_off, rtol,
               atol, min_step, max_iters, barrier, t0=t0)


def _exact_run_plain(bg, y0, ug0, vg0, h0, f0, bounds_g, n_bounds, cut_off,
                     rtol, atol, min_step, max_iters=1_000_000,
                     barrier=False, t0=None) -> GroupedRun:
    """The plain PyTorch version (any device): group by group
    ``_rk45_group_chunk`` and the truncation count, rows written into one
    preallocated output."""
    n_groups, group = bounds_g.shape
    ys, ugs, vgs, lane_att, trunc = _run_buffers(y0, n_groups, group)
    ys[0], ugs[0], vgs[0] = y0, ug0, vg0
    carry = (y0, _entry_time(t0, h0), h0, f0, y0[S_LON], y0[S_LAT])
    for g, bounds in enumerate(bounds_g):
        carry, (hist, gu, gv, _, _, la) = _rk45_group_chunk(
            bg, *carry, bounds, cut_off, rtol, atol, min_step, max_iters,
            barrier)
        # Counted after the group: a lane short of its last bound while
        # alive (a killed lane's state is NaN).
        trunc += (carry[1] < bounds[-1]) & ~torch.isnan(carry[0][0])
        sl = slice(1 + g * group, 1 + (g + 1) * group)
        ys[sl], ugs[sl], vgs[sl] = hist, gu, gv
        lane_att[g] = la
    nt = n_bounds + 1
    return GroupedRun(ys[:nt], ugs[:nt], vgs[:nt], lane_att, trunc, carry)


def _exact_run_cuda(bg, y0, ug0, vg0, h0, f0, bounds_g, n_bounds, cut_off,
                    rtol, atol, min_step, max_iters=1_000_000,
                    barrier=False, instance=None, t0=None, *, _blocks=None,
                    _repack=None, _trigger=None) -> GroupedRun:
    """Launch the whole-run exact kernel once: each lane walks every group
    and writes its rows straight into the output; with a float64 state the
    blocks of a persistent grid (``exact_grid``) repack their live lanes on
    the schedule ``EXACT_SCHEDULE`` gives the dtypes and take queued lanes
    into the freed threads. ``instance`` (a key of ``kernels.INSTANCES``)
    overrides ``rk45.exact_instance``'s choice. Reads nothing back from
    the card. A float64 state over a float32 background takes the mixed
    instance, and a time-varying or ensemble background the time instance,
    as ``_dense_run_cuda``.

    ``_blocks``, ``_repack`` and ``_trigger`` (another grid or repack
    schedule, with a float64 state) are for the card tests and the
    measurement scripts; none changes a bit of the output."""
    global EXACT_LAUNCHES
    key, (variant, bg_args) = _check_run_args(bg, y0, ug0, vg0, h0, f0,
                                              bounds_g, n_bounds, 0)
    dev, dt = y0.device, y0.dtype
    cut_off, rtol, atol, min_step = (rk45_mod.as_scalar(x, dt)
                                     for x in (cut_off, rtol, atol, min_step))
    r = y0.shape[1]
    instance = instance or rk45_mod.exact_instance(r, key, variant=variant)
    schedule = EXACT_SCHEDULE[key]
    blocks = every = trigger = 1
    if schedule is None:
        if (_blocks, _repack, _trigger) != (None, None, None):
            raise ValueError("_blocks, _repack and _trigger are for the "
                             "repacked (float64-state) exact run")
    else:
        every, trigger = schedule
        blocks = (exact_grid(key, variant, instance)[0] if _blocks is None
                  else _blocks)
        every = every if _repack is None else _repack
        if _trigger is not None:
            trigger = _trigger
        elif trigger is None:
            trigger = 1 << 30  # no window ends early
        if min(int(blocks), int(every), int(trigger)) < 1:
            raise ValueError(f"_blocks ({blocks}), _repack ({every}) and "
                             f"_trigger ({trigger}) must be at least 1")
    n_groups, group = bounds_g.shape
    ys, ugs, vgs, lane_att, trunc = _run_buffers(y0, n_groups, group)
    # The carry, updated in place by the kernel.
    y, h, f = y0.clone(), h0.clone(), f0.clone()
    t = _entry_time(t0, h0).clone()
    plon = torch.empty_like(h0)
    plat = torch.empty_like(h0)
    # The lane queue's counter, scratch for the repacked kernel.
    queue = torch.zeros(1, dtype=torch.int32, device=dev)
    ug0, vg0 = ug0.to(dt), vg0.to(dt)
    kernels.launch(
        f"rwrt_exact_run{variant}", key, *bg_args, y, t, h, f, plon, plat,
        ug0, vg0, ys, ugs, vgs, lane_att, trunc, bounds_g, group, n_groups,
        r, cut_off, rtol, atol, min_step, int(max_iters), int(barrier),
        kernels.instance_id(instance), int(blocks), queue, int(every),
        int(trigger), kernels.stream(dev))
    EXACT_LAUNCHES += 1
    nt = n_bounds + 1
    return GroupedRun(ys[:nt], ugs[:nt], vgs[:nt], lane_att, trunc,
                      (y, t, h, f, plon, plat))


def padded_bounds(dt, nt, group, dtype, device):
    """The (n_groups, group) output times of a run of nt rows: bounds dt,
    2 dt, ..., padded to whole groups by repeating the final time, which
    finished rays cross at once (the extra rows are discarded)."""
    n_groups = -(-(nt - 1) // group)
    bounds = torch.arange(1, n_groups * group + 1, dtype=dtype,
                          device=device) * dt
    return torch.clamp(bounds, max=(nt - 1) * dt).reshape(n_groups, group)


def _run_outputs(run: GroupedRun):
    """(ys, ugs, vgs, iters, nfev, trunc, lane_att) of a grouped run: iters
    (n_groups,) the most step attempts of a lane in each group, nfev =
    6 * iters, trunc the lane-groups the backstop cut short summed, a
    0-dim tensor on the run's device (read by ``_check_truncation``)."""
    iters = run.lane_att.amax(dim=1)
    return (run.ys, run.ugs, run.vgs, iters, 6 * iters, run.trunc.sum(),
            run.lane_att)


def _run_rk45_grouped(bg, y0, ug0, vg0, dt, nt, cut_off, rtol, atol,
                      min_step, group: int = 8, dense: bool = False,
                      pin_limit=None, pin_mwn=None,
                      max_iters: int = 1_000_000):
    """Adaptive run over groups of ``group`` output bounds (the JAX
    package's grouped runner): the set-up (initial steps, f0, padded
    bounds), then ``_dense_run`` (dense=True, with the optional pin-kill)
    or ``_exact_run``.

    Returns ``_run_outputs``: (ys, ugs, vgs, iters, nfev, trunc, lane_att),
    lane_att (n_groups, R) the step attempts per group and lane. In exact
    mode iters leaves out the bound-per-trip walk of NaN-amp lanes, which
    the JAX package's trip count includes.
    """
    h0, f0 = entry_stage(bg, y0, 0.0, rtol, atol)
    bounds_g = padded_bounds(dt, nt, group, y0.dtype, y0.device)
    args = (bg, y0, ug0, vg0, h0, f0, bounds_g, nt - 1, cut_off, rtol, atol,
            min_step, max_iters)
    if dense:
        return _run_outputs(_dense_run(*args, pin_limit, pin_mwn))
    if pin_limit is not None:
        raise ValueError("pin_limit is implemented for dense mode only")
    return _run_outputs(_exact_run(*args))


def _rk45_chunk(bg, y, t, h, t_bounds, cut_off, rtol, atol, min_step,
                max_iters=100_000):
    """Adaptive steps to each of t_bounds from carry (y, t, h): the barrier
    path, plain PyTorch on every device. Per bound ``integrate_interval``,
    then the kill test against the interval's entry state and (ug, vg) at
    the saved state.

    Returns ((y, t, h), (ys, ugs, vgs, iters, nfev, lane_att, trunc)), each
    stacked over the bounds: ys (n, 5, R), ugs and vgs (n, R), iters and
    nfev (n,) the batch-wide attempts, and two additions to the JAX
    return: lane_att (n, R) int32 each lane's attempts, trunc (n,) the
    lanes each interval's backstop left short of its bound while alive.
    """

    def rhs_fn(yy, tt=0.0):
        return ray_mod._rhs_core(bg, yy, tt, False)[0]

    cut_off = rk45_mod.as_scalar(cut_off, y.dtype)
    n, r = t_bounds.shape[0], y.shape[1]
    ys = torch.empty((n, 5, r), dtype=y.dtype, device=y.device)
    ugs = torch.empty((n, r), dtype=y.dtype, device=y.device)
    vgs = torch.empty_like(ugs)
    lane_att = torch.empty((n, r), dtype=torch.int32, device=y.device)
    iters = torch.empty(n, dtype=torch.int64)
    trunc = torch.empty(n, dtype=torch.int64, device=y.device)
    for j, t_bound in enumerate(t_bounds):
        y_new, t, h, iters[j], _, lane_att[j] = rk45_mod.integrate_interval(
            rhs_fn, y, t, h, t_bound, rtol, atol, min_step, max_iters)
        trunc[j] = torch.sum((t < t_bound) & ~torch.isnan(y_new[S_LON]))
        kill = ray_mod.kill_mask(y_new, y[S_LON], y[S_LAT], cut_off)
        y = torch.where(kill[None, :], torch.full_like(y_new, float("nan")),
                        y_new)
        ys[j] = y
        ugs[j], vgs[j] = ray_mod.group_velocity_at(
            bg, y[S_LON], y[S_LAT], y[S_KX], y[S_KY], t_bound)
    return (y, t, h), (ys, ugs, vgs, iters, 6 * iters, lane_att, trunc)


def _run_rk45(bg, y0, ug0, vg0, dt, nt, cut_off, rtol, atol, min_step,
              max_iters: int = 100_000):
    """The exact adaptive run bound by bound (the JAX package's barrier
    path, which ``trace_rays`` takes when interval_batch is 1 or nt <= 2).

    On a CPU state the plain barrier path ``_rk45_chunk`` runs. On a CUDA
    state the exact-run kernel runs it in one launch, with one bound per
    group and the barrier flag: a lane whose amp turns NaN inside an
    interval keeps stepping to the bound, as on the barrier path, and is
    walked as frozen from the next bound on. So the two are bitwise equal
    (``_exact_run_plain`` with the same arguments is what the card runs).
    Truncation is counted per interval on both: a lane the max_iters
    backstop leaves short of any bound while alive counts, where the JAX
    package counts only lanes short of the final bound and returns the
    frozen rows of the others (ROADMAP Queue 3).

    Returns (ys, ugs, vgs, iters, nfev, trunc, lane_att) as
    ``_run_rk45_grouped`` does, with one group per output interval.
    """
    if y0.is_cuda:
        h0, f0 = entry_stage(bg, y0, 0.0, rtol, atol)
        bounds_g = padded_bounds(dt, nt, 1, y0.dtype, y0.device)
        return _run_outputs(_exact_run_cuda(
            bg, y0, ug0, vg0, h0, f0, bounds_g, nt - 1, cut_off, rtol, atol,
            min_step, max_iters, barrier=True))
    h0 = initial_step_sizes(bg, y0, rtol, atol)
    t_bounds = torch.arange(1, nt, dtype=y0.dtype, device=y0.device) * dt
    _, (ys, ugs, vgs, iters, nfev, lane_att, trunc) = _rk45_chunk(
        bg, y0, torch.zeros_like(y0[0]), h0, t_bounds, cut_off, rtol, atol,
        min_step, max_iters)
    return (torch.cat([y0[None], ys]), torch.cat([ug0[None], ugs]),
            torch.cat([vg0[None], vgs]), iters, nfev, trunc.sum(), lane_att)


def _run_rk4(bg, y0, ug0, vg0, dt, nt, cut_off):
    """The fixed-step RK4 run of nt rows, (ys (nt, 5, R), ugs, vgs (nt, R))
    with y0, ug0, vg0 in row 0. On a CUDA state one launch of
    ``csrc/rk4_run.cu`` (``_run_rk4_cuda``); on a CPU state the plain
    ``solvers/rk4.trace`` (``_run_rk4_plain``)."""
    run = _run_rk4_cuda if y0.is_cuda else _run_rk4_plain
    return run(bg, y0, ug0, vg0, dt, nt, cut_off)


def _run_rk4_plain(bg, y0, ug0, vg0, dt, nt, cut_off):
    """The plain PyTorch version (any device)."""
    return rk4_mod.trace(bg, y0, dt, nt, cut_off, ug0, vg0)


def _rk4_buffers(y, rows):
    r = y.shape[1]
    ys = torch.empty((rows, 5, r), dtype=y.dtype, device=y.device)
    ugs = torch.empty((rows, r), dtype=y.dtype, device=y.device)
    return ys, ugs, torch.empty_like(ugs)


def _run_rk4_cuda(bg, y0, ug0, vg0, dt, nt, cut_off, instance=None):
    """One launch of the RK4 kernel writes all nt rows, row 0 included."""
    ys, ugs, vgs = _rk4_buffers(y0, nt)
    _rk4_launch(bg, y0, dt, nt - 1, cut_off, ys, ugs, vgs, 1, ug0, vg0,
                instance)
    return ys, ugs, vgs


def _rk4_chunk(bg, y, dt, n_steps: int, cut_off, t_start=0.0):
    """n_steps RK4 output steps from carry y entered at time t_start (the
    model time of the carry's row); returns (y, (ys, ugs, vgs)) with
    n_steps rows each. On a CUDA state one launch of the RK4 kernel; on a
    CPU state the plain loop."""
    ys, ugs, vgs = _rk4_buffers(y, n_steps)
    if y.is_cuda:
        y = _rk4_launch(bg, y, dt, n_steps, cut_off, ys, ugs, vgs, 0,
                        t_start=t_start)
    else:
        y = rk4_mod.trace_into(bg, y, dt, n_steps, cut_off, ys, ugs, vgs,
                               t_start=t_start)
    return y, (ys, ugs, vgs)


def _rk4_launch(bg, y, dt, n_steps, cut_off, ys, ugs, vgs, row_offset,
                ug0=None, vg0=None, instance=None, t_start=0.0):
    """Launch the RK4 kernel once: n_steps steps from carry y (5, R)
    entered at time t_start, step s (at t_start + s dt) written at row
    row_offset + s of ys (rows, 5, R), ugs and vgs (rows, R); with ug0,
    vg0 (R,) given, row row_offset - 1 receives y and them (widened to the
    state's dtype). ``instance`` (a key of ``kernels.INSTANCES``) overrides
    ``rk4_instance``'s choice. A float64 state over a float32 background
    takes the mixed instance, a time-varying or ensemble background the
    time instance. Returns the carry after the last step; reads nothing
    back from the card."""
    global RK4_LAUNCHES
    dev, dtype = y.device, y.dtype
    key = kernels.state_key(y, bg.fields)
    if y.ndim != 2 or y.shape[0] != 5:
        raise ValueError(f"y must be (5, R); got {tuple(y.shape)}")
    if (ug0 is None) != (vg0 is None):
        raise ValueError("ug0 and vg0 are given together")
    r = y.shape[1]
    rows = ys.shape[0]
    first = row_offset - (ug0 is not None)
    if n_steps < 0 or first < 0 or row_offset + n_steps > rows:
        raise ValueError(f"rows {first}..{row_offset + n_steps - 1} outside "
                         f"the {rows}-row output")
    checks = [("y", y, (5, r)), ("ys", ys, (rows, 5, r)),
              ("ugs", ugs, (rows, r)), ("vgs", vgs, (rows, r))]
    if ug0 is not None:
        ug0, vg0 = ug0.to(dtype), vg0.to(dtype)
        checks += [("ug0", ug0, (r,)), ("vg0", vg0, (r,))]
    for name, x, shape in checks:
        kernels.check_tensor(x, name, device=dev, dtype=dtype, shape=shape)
    variant, bg_args = ray_mod.kernel_background(bg, dev, key[1], r)
    dt, half, sixth = rk4_mod.step_factors(dt, dtype)
    y = y.clone()  # the carry, updated in place by the kernel
    extra = (rk45_mod.as_scalar(t_start, dtype),) if variant else ()
    kernels.launch(
        f"rwrt_rk4_run{variant}", key, *bg_args, y, ug0, vg0, ys, ugs, vgs,
        n_steps, row_offset, r, dt, half, sixth,
        rk45_mod.as_scalar(cut_off, dtype), *extra,
        kernels.instance_id(instance or rk4_instance(r, key, variant)),
        kernels.stream(dev))
    RK4_LAUNCHES += 1
    return y


class MaxItersTruncation(RuntimeError):
    """The adaptive loop's max_iters backstop cut lanes off short of their
    output bounds: the emitted history would be silently frozen mid-interval
    for those lanes, so the runner refuses to return it. In dense mode, arm
    the straggler pin-kill (RunConfig.pin_limit, pin_mwn=0)."""


def _check_truncation(trunc):
    """Raise ``MaxItersTruncation`` where ``trunc`` (a count, or a tensor
    of counts on any device: one host read) sums to more than 0."""
    n = int(_read(torch.as_tensor(trunc).sum()))
    if n:
        raise MaxItersTruncation(
            f"adaptive integration hit the max_iters backstop with {n} "
            "unfinished lane-group(s); history would be silently frozen "
            "mid-interval. Arm the straggler pin-kill (pin_limit, "
            "pin_mwn=0) in dense mode."
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


def _run_sharded(mesh, bg, lanes, call):
    """``call(bg, *lanes)`` once per shard of ``mesh``: the per-lane
    tensors ``lanes`` (ray axis last) and an ensemble's member map padded
    to a multiple of the mesh size (NaN lanes, member 0) and split into
    contiguous shards, the background copied once to each distinct device
    (``parallel.sharding``). Each call runs inside its device's guard, so
    its launches go to that card and its current stream; shards that share
    a device run one after another, shards on distinct devices overlap.
    The calls make no host read, so every shard's launches are issued
    before the caller's first. Returns (the calls' outputs in mesh order,
    the real lane count R)."""
    r = lanes[0].shape[-1]
    ids = bg.member_ids
    if ids is not None:
        lanes = tuple(lanes) + (ids,)
    parts = [sharding.shard_rays(sharding.pad_rays(x, mesh.size)[0], mesh)
             for x in lanes]
    bgs = sharding.replicate(bg._replace(member_ids=None), mesh)
    outs = []
    for i, d in enumerate(mesh.devices):
        shard = [p[i] for p in parts]
        b = bgs[i]
        if ids is not None:
            b = b._replace(member_ids=shard.pop())
        with sharding.device_guard(d):
            outs.append(call(b, *shard))
    return outs, r


def _gather_lanes(parts, r, device):
    """The shards' tensors ``parts`` gathered along the ray axis on
    ``device``, the pad lanes dropped."""
    out = sharding.gather_rays(parts, device)
    return out if out.shape[-1] == r else out[..., :r]


def gather_tree(outs, r, device):
    """The shards' outputs of a unit whose every tensor is per lane (a
    ``GroupedRun``, or ``_rk4_chunk``'s (y, (ys, ugs, vgs))), gathered
    along the ray axis on ``device`` with the pad lanes dropped."""
    first = outs[0]
    if torch.is_tensor(first):
        return _gather_lanes(outs, r, device)
    vals = [gather_tree([o[k] for o in outs], r, device)
            for k in range(len(first))]
    return type(first)(*vals) if hasattr(first, "_fields") else tuple(vals)


def seed_state(bg, source_lon, source_lat, zwn, config: RunConfig,
               initial_state=None):
    """The run's seeds (y0 (5, R), ug0, vg0 (R,)): ``initialize`` in the
    config's root order, or ``initial_state`` (a (5, R) array or tensor,
    R = 3 * nsource * nzwn in (root, source, zwn) C order) in the
    background's dtype with (ug0, vg0) from ``ray.group_velocity_at`` at
    it (zero-invalid), the reference's initial-condition injection hook."""
    y0, ug0, vg0 = initialize(bg, source_lon, source_lat, zwn,
                              config.root_order)
    if initial_state is None:
        return y0, ug0, vg0
    y0 = _upload(torch.as_tensor(initial_state), bg.fields.device,
                 bg.fields.dtype)
    want = (5, 3 * source_lon.shape[0] * zwn.shape[0])
    if tuple(y0.shape) != want:
        raise ValueError(f"initial_state shape {tuple(y0.shape)} mismatch; "
                         f"expected {want}")
    ug0, vg0 = ray_mod.group_velocity_at(
        bg, y0[S_LON], y0[S_LAT], y0[S_KX], y0[S_KY], zero_invalid=True)
    return y0.contiguous(), ug0, vg0


@observability.spanned("rwrt.trace_rays")
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
    """Run the ray-tracing pipeline on ``bs``'s device: fixed-step RK4
    (integrator='rk4'), or adaptive RK45 with exact bounds
    (bound_mode='exact') or dense output (bound_mode='dense', optionally
    with pin_limit). On the card the integration is one kernel launch.
    With state_dtype='float64' the state is carried in float64 over the
    background's dtype (mixed precision when that is float32): all seven
    outputs are float64.

    Args:
      bs: prepared basic state (its device and dtype are the background's,
        and the run's unless state_dtype is 'float64').
      config: run configuration.
      source_lon/source_lat: optional explicit source arrays in RADIANS;
        default: the config's regular source matrix.
      mesh: optional ``parallel.sharding.Mesh`` of the state's device type:
        the (compacted) lanes split into one shard per mesh entry, each
        shard the branch's run over its lanes (one launch on the card),
        the background copied to every device; rows, (ug, vg), truncation
        and ``stats`` bitwise those of the run without it, and on the
        state's device.
      initial_state: optional (5, R) state overriding the computed seeds
        (``seed_state``); rootless compaction then runs on it as usual.
      auto_chunk_bytes: the run holds its whole (nt, 7, R) history on the
        device; past this estimate of it (2 * nt * R * 7 * itemsize of the
        background's dtype) the run goes through the chunked driver
        (``utils.checkpoint.trace_rays_chunked``, default chunk_steps),
        which keeps the history on the host, as the JAX package does. Such
        a run returns CPU tensors, and in dense mode its rows depend on the
        chunk split at tolerance level (chunk boundaries clamp a step as a
        group's last bound does). None disables the rerouting.
      stats: optional dict. An rk45 run (either bound mode) puts
        "lane_att" there: the (n_groups, R') int32 step attempts per group
        of bounds (one group per output interval when interval_batch is 1
        or nt <= 2) of the R' integrated (compacted) lanes, on the run's
        device, also when the run then raises ``MaxItersTruncation``.
        Under a mesh also "shard_iters": (n_shards, n_groups), the most
        attempts of a lane of each shard in each group (the JAX package's
        per-shard loop counts). An rk4 run takes no adaptive steps and
        puts nothing there. A rerouted run fills it as
        ``trace_rays_chunked`` does.

    Under a recording ``torch.profiler`` the call is the span
    ``rwrt.trace_rays`` (``utils.observability.span``), its stages the
    spans ``rwrt.inputs`` (the uploads, ``make_background``),
    ``rwrt.seed`` (``seed_state``) and ``_run_lanes``' in turn.
    """
    config.validate()
    dtype = bs.fields.dtype
    device = bs.fields.device
    mesh = sharding.check_mesh(mesh, device)
    if auto_chunk_bytes is not None:
        n_lanes = 3 * (config.nsource if source_lon is None
                       else np.asarray(source_lon).shape[0]) * config.nzwn
        itemsize = torch.empty((), dtype=dtype).element_size()
        est = 2 * config.nt * n_lanes * 7 * itemsize
        if est > auto_chunk_bytes:
            from rwrt_tpu_torch.utils import checkpoint

            return checkpoint.trace_rays_chunked(
                bs, config, verbose=False, source_lon=source_lon,
                source_lat=source_lat, mesh=mesh,
                initial_state=initial_state, stats=stats)
    with observability.span("rwrt.inputs"):
        if source_lon is None:
            source_lon, source_lat = source_matrix(
                config.sw_lon, config.sw_lat, config.dlon, config.dlat,
                config.nnx, config.nny,
            )
        source_lon = _upload(source_lon, device, dtype)
        source_lat = _upload(source_lat, device, dtype)
        zwn = _upload(config.zwn_array(), device, dtype)
        bg = make_background(bs, config.freq)
    with observability.span("rwrt.seed"):
        y0, ug0, vg0 = seed_state(bg, source_lon, source_lat, zwn, config,
                                  initial_state)
    ys, ugs, vgs = _run_lanes(bg, y0, ug0, vg0, config,
                              config.state_dtype == "float64", stats, mesh)
    out_shape = (config.nt, 3, source_lon.shape[0], len(config.zwn))
    return _traj_from(ys, ugs, vgs, lambda a: a.reshape(out_shape))


def _run_lanes(bg, y0, ug0, vg0, config: RunConfig, wide: bool,
               stats: Optional[dict], mesh=None):
    """Integrate the seeded lanes (y0 (5, R), ug0, vg0 (R,)) over ``bg`` as
    ``config`` says: rootless lanes compacted away (an ensemble's member
    map moves with its lanes), the state widened to float64 when ``wide``
    (mixed precision), the branch's run (over a ``mesh``, one per shard
    of the compacted lanes, ``_run_sharded``), the truncation check, and
    the compacted lanes expanded back; each stage a span
    (``rwrt.compact``, ``rwrt.run``, ``rwrt.truncation``, ``rwrt.expand``).
    Returns (ys (nt, 5, R), ugs, vgs (nt, R))."""
    device = y0.device
    n_rays = y0.shape[1]
    y0_full, ug0_full, vg0_full = y0, ug0, vg0
    take = None
    if config.compact_rootless:
        with observability.span("rwrt.compact"):
            idx = compact_lane_indices(
                _read(torch.isfinite(y0[4])).numpy())
            if idx is not None:
                take = _upload(idx, device)
                y0 = y0.index_select(1, take).contiguous()
                ug0 = ug0.index_select(0, take)
                vg0 = vg0.index_select(0, take)
                if bg.member_ids is not None:
                    bg = bg._replace(
                        member_ids=bg.member_ids.index_select(0, take))
    n_lanes = y0.shape[1]

    nt = config.nt
    trunc = None
    with observability.span("rwrt.run"):
        if wide:
            # Mixed precision: the state, the run's scalars and the
            # controller in float64; the RHS rounds the state to the
            # background's dtype at entry (models/ray.py). The cast is
            # exact, and a no-op over a float64 background.
            y0 = y0.to(torch.float64)
        dtype = y0.dtype
        dt = rk45_mod.as_scalar(config.tstep, dtype)
        cut_off = rk45_mod.as_scalar(config.cut_off_rad, dtype)

        def run(runner, *args, **kw):
            """``runner`` over the lanes, or over each shard of them: its
            per-lane outputs (rows, and an adaptive run's lane_att)
            gathered; an adaptive run's trunc and iters per shard, iters
            (n_shards, n_groups) the most attempts of a shard's real lane
            in each group."""
            if mesh is None:
                return runner(bg, y0, ug0, vg0, *args, **kw)
            outs, r = _run_sharded(mesh, bg, (y0, ug0, vg0),
                                   lambda *a: runner(*a, *args, **kw))
            rows = gather_tree([o[:3] for o in outs], r, device)
            if len(outs[0]) == 3:
                return rows
            lane_att = _gather_lanes([o[6] for o in outs], r, device)
            w = outs[0][6].shape[1]
            iters = torch.nn.functional.pad(lane_att, (0, mesh.size * w - r))
            iters = iters.reshape(-1, mesh.size, w).amax(dim=2).T
            return (*rows, iters, 6 * iters,
                    torch.stack([o[5].to(device) for o in outs]), lane_att)

        if config.integrator == "rk4":
            ys, ugs, vgs = run(_run_rk4, dt, nt, cut_off)
        else:
            min_step = min(config.min_step_factor * config.tstep,
                           config.tstep * 1e-3)
            rtol = rk45_mod.validate_tol(config.rtol, dtype)
            atol = rk45_mod.as_scalar(config.atol, dtype)
            min_step = rk45_mod.as_scalar(min_step, dtype)
            if config.interval_batch > 1 and nt > 2:
                out = run(
                    _run_rk45_grouped, dt, nt, cut_off, rtol, atol,
                    min_step, group=min(config.interval_batch, nt - 1),
                    dense=config.bound_mode == "dense",
                    pin_limit=config.pin_limit,
                    pin_mwn=(None if config.pin_limit is None
                             else config.pin_mwn),
                )
            else:
                out = run(_run_rk45, dt, nt, cut_off, rtol, atol, min_step)
            ys, ugs, vgs, iters, _, trunc, lane_att = out
            if stats is not None:
                stats["lane_att"] = lane_att
                if mesh is not None:
                    stats["shard_iters"] = iters
    if trunc is not None:
        with observability.span("rwrt.truncation"):
            _check_truncation(trunc)

    if take is None:
        return ys, ugs, vgs
    # Expand the compacted lanes back into the full layout. Rootless lanes'
    # histories are integrator-specific, as in the JAX package: the
    # adaptive solver freezes them at their seed state (finite lon/lat/kx,
    # NaN ky/amp), while RK4 writes the NaN step proposal back (all NaN from
    # step 1). (ug, vg) are NaN beyond step 0 either way. The targets take
    # the history's dtype, which a float64 state makes wider than the
    # seeds'.
    with observability.span("rwrt.expand"):
        if config.integrator == "rk45":
            ys_f = y0_full[None].to(dtype).expand(
                (nt,) + tuple(y0_full.shape)).clone()
        else:
            ys_f = torch.full((nt,) + tuple(y0_full.shape), float("nan"),
                              dtype=dtype, device=device)
            ys_f[0] = y0_full
        ys_f[..., take] = ys[..., :n_lanes]
        ugs_f = torch.full((nt, n_rays), float("nan"), dtype=dtype,
                           device=device)
        vgs_f = ugs_f.clone()
        ugs_f[0] = ug0_full
        vgs_f[0] = vg0_full
        ugs_f[:, take] = ugs[:, :n_lanes]
        vgs_f[:, take] = vgs[:, :n_lanes]
    return ys_f, ugs_f, vgs_f


@observability.spanned("rwrt.trace_rays_ensemble")
def trace_rays_ensemble(bs_members, config: RunConfig, source_lon=None,
                        source_lat=None, mesh=None,
                        stats: Optional[dict] = None):
    """An ensemble sweep: ``trace_rays`` over each background state of
    ``bs_members`` (e.g. one per reanalysis year), in one run. Returns a
    list of ``RayTrajectories``, one per member.

    The members are flattened member-major into the lane axis over one
    stacked background ((M, W, H, 48), or (M, T, W, H, 48) for time-varying
    members) with a per-lane member map folded into the row gather
    (``ray.sample_bg``), rk4 and rk45 alike; on the card that is one launch
    of the branch's whole-run kernel (its time instance) for all members.
    A lane's rows never depend on another lane's, so each member's rows are
    those of its own ``trace_rays``. Rootless lanes are compacted away as
    in ``trace_rays`` (their member ids move with them).

    All members share the grid shape and dtype; time-varying members also
    their frame count and time axis (bg_t0, bg_dt), else ValueError. The
    run is in the fields' dtype: ``config.state_dtype`` is not read, as in
    the JAX package. ``mesh``: as ``trace_rays``' (the flattened lanes
    split, each shard's member map with them; pad lanes take member 0).
    ``stats``: as ``trace_rays``' (the flattened lanes' attempts of an
    rk45 run). Spans as ``trace_rays``', the root ``rwrt.trace_rays_ensemble``
    (``rwrt.inputs`` holds the members' backgrounds and their stack,
    ``rwrt.seed`` the stack's ``initialize``: on the card one seed launch
    for all members).
    """
    config.validate()
    if not bs_members:
        raise ValueError("an ensemble needs at least one member")
    first = bs_members[0]
    dtype = first.fields.dtype
    device = first.fields.device
    mesh = sharding.check_mesh(mesh, device)
    for m in bs_members[1:]:
        if m.fields.shape != first.fields.shape or m.fields.dtype != dtype:
            raise ValueError("ensemble members must share the grid shape, "
                             "frame count and dtype")
        if first.fields.ndim == 4 and (m.bg_t0 != first.bg_t0
                                       or m.bg_dt != first.bg_dt):
            raise ValueError("time-varying ensemble members must share frame "
                             "count and time metadata (bg_t0, bg_dt)")
    with observability.span("rwrt.inputs"):
        if source_lon is None:
            source_lon, source_lat = source_matrix(
                config.sw_lon, config.sw_lat, config.dlon, config.dlat,
                config.nnx, config.nny,
            )
        source_lon = _upload(source_lon, device, dtype)
        source_lat = _upload(source_lat, device, dtype)
        zwn = _upload(config.zwn_array(), device, dtype)
        members = [make_background(m, config.freq) for m in bs_members]
        r_single = 3 * source_lon.shape[0] * zwn.shape[0]
        ens_bg = members[0]._replace(
            fields=torch.stack([bg.fields for bg in members]).contiguous(),
            member_ids=torch.arange(
                len(members), dtype=torch.int32,
                device=device).repeat_interleave(r_single))
    with observability.span("rwrt.seed"):
        y0, ug0, vg0 = initialize(ens_bg, source_lon, source_lat, zwn,
                                  config.root_order)
    ys, ugs, vgs = _run_lanes(ens_bg, y0, ug0, vg0, config, False, stats,
                              mesh)
    out_shape = (config.nt, 3, source_lon.shape[0], len(config.zwn))
    return [_traj_from(*(a[..., i * r_single:(i + 1) * r_single]
                         for a in (ys, ugs, vgs)),
                       lambda a: a.reshape(out_shape))
            for i in range(len(members))]


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
