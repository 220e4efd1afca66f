"""Chunked integration driver with checkpoint/resume and progress reporting
(port of ``rwrt_tpu/utils/checkpoint.py``).

The whole integration state is one small carry: the (5, R) ray state plus,
for the adaptive solver, per-ray (t, h). This module runs the integration
in chunks of output intervals, keeps the history on the host (in RAM, or
streamed to memmapped ``.npy`` files), and between chunks can checkpoint
the carry and the history, resume from a checkpoint, reorder the lanes by
grid cell and drop dead lanes from the batch.

Each chunk is one call of a unit the port's ``trace_rays`` also runs, so on
the card one kernel launch: ``tracer._rk4_chunk`` (rk4), ``tracer._dense_run``
over one group of the chunk's bounds (rk45, bound_mode='dense'),
``tracer._exact_run`` over one group (rk45 exact, interval_batch > 1) or
over one-bound groups with the barrier flag (interval_batch = 1). The JAX
driver picks among more schedulers for the grouped chunk (peel scheduling,
difficulty buckets); each is bitwise equal per lane to its plain chunk,
which is the unit here: on the card one thread carries a lane through the
launch, so the launch pays for its longest lane, not for trips times
width, and there is nothing for a scheduler to win.

Over a device mesh (``parallel/sharding.py``) the lanes are padded once
with NaN lanes to a multiple of the mesh size (their history slots lie
past the rays' and are dropped) and every unit, the entry stage's too,
runs once per shard (``tracer._run_sharded``): one launch per shard per
chunk. The carry is gathered after each chunk, where the host reorders
and compacts it, and split again for the next.

The checkpoint is the JAX driver's npz (``step, y, t, h, lanes, n_rays,
hist_*``): a checkpoint written by either package resumes in the other.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch

from rwrt_tpu_torch import tracer as _tracer
from rwrt_tpu_torch.config import RunConfig
from rwrt_tpu_torch.models import ray as ray_mod
from rwrt_tpu_torch.models.basic_state import BasicState
from rwrt_tpu_torch.parallel import sharding
from rwrt_tpu_torch.solvers import rk45 as rk45_mod
from rwrt_tpu_torch.utils.observability import Progress, run_banner

FIELDS = ("lon", "lat", "kx", "ky", "amp", "ug", "vg")

#: The adaptive units' max_iters backstop, as ``trace_rays`` has it: per
#: lane and group on the grouped path, per lane and output interval on the
#: barrier path (interval_batch = 1).
MAX_ITERS = 1_000_000
BARRIER_MAX_ITERS = 100_000


def _take_lanes(arr: torch.Tensor, idx: np.ndarray) -> torch.Tensor:
    """Gather along the trailing lane axis: the one helper behind every
    lane reorder or subset of the driver (resorting, mid-run compaction)."""
    return arr.index_select(-1, torch.as_tensor(idx, device=arr.device))


def _save(path, step, y, t, h, hist, lanes, n_rays):
    tmp = path + ".tmp.npz"
    np.savez_compressed(
        tmp, step=step, y=y, t=t, h=h, lanes=lanes, n_rays=n_rays,
        **{f"hist_{k}": v for k, v in hist.items()},
    )
    os.replace(tmp, path)


def _load(path):
    with np.load(path) as ds:
        step = int(ds["step"])
        y, t, h = ds["y"], ds["t"], ds["h"]
        lanes = ds["lanes"] if "lanes" in ds.files else None
        n_rays = int(ds["n_rays"]) if "n_rays" in ds.files else None
        hist = {k[5:]: ds[k] for k in ds.files if k.startswith("hist_")}
    return step, y, t, h, hist, lanes, n_rays


class ChunkBudgetReached(RuntimeError):
    """Raised by trace_rays_chunked(max_chunks=...) after the budgeted
    number of chunks: the checkpoint (and any streamed history) hold
    everything computed so far; re-invoking with the same checkpoint_path
    resumes. Lets a caller bound one process's run and chain attempts."""

    def __init__(self, step, nt):
        super().__init__(f"chunk budget reached at output step {step}/{nt}")
        self.step = step
        self.nt = nt


class _Split:
    """Where a chunk's time goes, kept in ``stats`` when the caller passes
    one: "chunk_ms", each chunk's unit on the device (CUDA events on the
    card, the wall on the CPU), and "seconds", the host's wall for the
    set-up before the first chunk (seeding, the checkpoint's load, the
    history's allocation and fill: "setup") and, summed over chunks, for
    the device-to-host copy of the rows ("d2h"), their scatter into the
    history ("scatter"), compaction ("compact") and the checkpoint
    ("checkpoint"). Costs nothing without ``stats``."""

    def __init__(self, stats, cuda):
        self.stats = stats
        self.cuda = cuda and stats is not None
        if stats is not None:
            stats.setdefault("chunk_ms", [])
            stats.setdefault("seconds", dict.fromkeys(
                ("setup", "d2h", "scatter", "compact", "checkpoint"), 0.0))
        self.mark()

    def unit_start(self):
        if self.stats is None:
            return
        if self.cuda:
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record()
        else:
            self.t0 = time.perf_counter()

    def unit_end(self):
        """Waits for the unit (the copy that follows waits anyway), so the
        copy's time is the copy's alone."""
        if self.stats is None:
            return
        if self.cuda:
            self.events[1].record()
            self.events[1].synchronize()
            ms = self.events[0].elapsed_time(self.events[1])
        else:
            ms = (time.perf_counter() - self.t0) * 1e3
        self.stats["chunk_ms"].append(ms)
        self.t0 = time.perf_counter()

    def lap(self, part):
        """Add the wall since the last mark to ``part``."""
        if self.stats is None:
            return
        now = time.perf_counter()
        self.stats["seconds"][part] += now - self.t0
        self.t0 = now

    def mark(self):
        if self.stats is not None:
            self.t0 = time.perf_counter()


def trace_rays_chunked(
    bs: BasicState,
    config: RunConfig,
    *,
    chunk_steps: int = 64,
    checkpoint_path: Optional[str] = None,
    resume: bool = True,
    verbose: bool = True,
    source_lon=None,
    source_lat=None,
    mesh=None,
    sort_rays: bool = False,
    initial_state=None,
    stream_dir: Optional[str] = None,
    compact_min_width: int = 256,
    max_chunks: Optional[int] = None,
    stats: Optional[dict] = None,
) -> _tracer.RayTrajectories:
    """Like ``tracer.trace_rays`` but in chunks of ``chunk_steps`` output
    steps, with progress, checkpointing and the history on the host.

    Returns a ``RayTrajectories`` of CPU tensors (nt, 3, nsource, nzwn) in
    the state's dtype, wherever ``bs`` lies. A chunk is one launch of the
    branch's whole-run kernel on the card; one device-to-host copy of its
    rows follows. The rows depend on ``chunk_steps`` as on interval_batch:
    a chunk boundary clamps a step as a group's last bound does (at
    tolerance level in dense mode). With chunk_steps equal to the run's
    group, the rows are ``trace_rays``' bit for bit, but for one corner:
    the kill test at a chunk's first bound measures the displacement from
    the carry state, as the JAX driver does after a resume, where in dense
    mode one launch measures it from the last emitted row, which can
    differ from the state in the last bits.

    sort_rays: reorder the lanes by their current background grid cell at
    every chunk boundary (on the host). Per-ray results are bit-identical
    (the units are per lane); history is written back through the
    lane->ray map, so outputs are in the original order.

    checkpoint_path, resume: save the carry and the history after every
    chunk, and start from the file when it exists (and ``resume``). A
    checkpoint written for another source configuration is refused.

    max_chunks: cooperative chunk budget: after this many chunks the
    driver checkpoints (checkpoint_path required) and raises
    ChunkBudgetReached instead of continuing; re-invoke to resume.

    stream_dir: stream the history to disk instead of holding it in host
    RAM: one memmapped ``<var>.npy`` per output, written chunk by chunk (a
    90-day 100,800-ray float32 run is ~3 GB of history). The returned
    tensors are then views of the memmaps (``torch.from_numpy``, no copy).

    compact_min_width: floor of the dead-lane-compaction width ladder (see
    RunConfig.compact_dead).

    mesh: optional ``parallel.sharding.Mesh`` of the state's device type:
    each chunk one launch per shard, rows bitwise those of the run without
    it; mid-run compaction keeps a multiple of the mesh size. A checkpoint
    written under a mesh resumes under a mesh of the same size only.

    initial_state: optional (5, R) state overriding the computed seeds, as
    for ``trace_rays`` (``tracer.seed_state``).

    stats: optional dict. An rk45 run appends each chunk's (groups, lanes)
    int32 step attempts to the list "lane_att" (on the run's device, the
    chunk's lanes after compaction; also for the chunk that raises
    ``MaxItersTruncation``); every run fills "chunk_ms" and "seconds"
    (see ``_Split``).

    Raises ``tracer.MaxItersTruncation`` at the first chunk where the
    max_iters backstop left a live lane short of a bound; the checkpoint
    then holds the run up to that chunk.
    """
    config.validate()
    if chunk_steps < 1:
        raise ValueError("chunk_steps must be >= 1")
    dtype = bs.fields.dtype
    device = bs.fields.device
    mesh = sharding.check_mesh(mesh, device)
    split = _Split(stats, device.type == "cuda")
    if source_lon is None:
        source_lon, source_lat = _tracer.source_matrix(
            config.sw_lon, config.sw_lat, config.dlon, config.dlat,
            config.nnx, config.nny,
        )

    def to_dev(a):
        return torch.as_tensor(np.asarray(a)).to(device=device, dtype=dtype)

    source_lon = to_dev(source_lon)
    source_lat = to_dev(source_lat)
    zwn = to_dev(config.zwn_array())

    bg = _tracer.make_background(bs, config.freq)
    y0, ug0, vg0 = _tracer.seed_state(bg, source_lon, source_lat, zwn,
                                      config, initial_state)
    nt = config.nt
    n_rays = y0.shape[1]
    # The seeds on the host: row 0 of the history and the rootless fill.
    y0_np, ug0_np, vg0_np = (x.cpu().numpy() for x in (y0, ug0, vg0))
    born0 = np.isfinite(y0_np[4])
    lane_to_ray = np.arange(n_rays)
    if config.compact_rootless:
        idx = _tracer.compact_lane_indices(born0)
        if idx is not None:
            lane_to_ray = idx
            y0 = _take_lanes(y0, idx)
    compacted = y0.shape[1] != n_rays
    if mesh is not None:
        # The NaN pad lanes' history slots lie past the rays' (the columns
        # the result leaves out).
        y0, _ = sharding.pad_rays(y0, mesh.size)
        lane_to_ray = np.concatenate([
            lane_to_ray,
            n_rays + np.arange(y0.shape[1] - lane_to_ray.shape[0])])
    n_lanes = y0.shape[1]
    if config.state_dtype == "float64":
        # Mixed precision, as trace_rays: the state and the controller in
        # float64 over the background's dtype.
        y0 = y0.to(torch.float64)
        dtype = y0.dtype
    dt = rk45_mod.as_scalar(config.tstep, dtype)
    cut_off = rk45_mod.as_scalar(config.cut_off_rad, dtype)
    rtol = rk45_mod.validate_tol(config.rtol, dtype)
    atol = rk45_mod.as_scalar(config.atol, dtype)
    min_step = rk45_mod.as_scalar(
        min(config.min_step_factor * config.tstep, config.tstep * 1e-3),
        dtype)

    if verbose:
        run_banner(config, bs.nlon, bs.nlat)

    hist_w = max(n_rays, int(lane_to_ray.max()) + 1 if n_lanes else n_rays)
    hist_dtype = torch.empty((), dtype=dtype).numpy().dtype

    # Load and VALIDATE any checkpoint before touching the stream files: a
    # rejected resume must raise while the streamed history of the original
    # run is still intact.
    y = y0
    t = torch.zeros(n_lanes, dtype=dtype, device=device)
    h = None
    start = 1
    hist_l = {}
    resuming = bool(checkpoint_path and resume
                    and os.path.exists(checkpoint_path))

    def to_state(a, what):
        a = np.asarray(a)
        if a.dtype != hist_dtype:
            raise ValueError(
                f"checkpoint {what} is {a.dtype}, this run's state "
                f"{hist_dtype}; the dtype configuration differs")
        return torch.as_tensor(a).to(device)

    if resuming:
        step, y_np, t_np, h_np, hist_l, lanes_np, n_rays_ck = _load(
            checkpoint_path)
        start = step
        if lanes_np is not None:
            # Adopt the stored lane set and order outright: it may be a
            # mid-run compaction SUBSET of the fresh map (the units are per
            # lane, so lane order is free). Lanes are stored sorted by ray.
            # The subset check alone cannot tell a compaction subset from a
            # checkpoint of a SMALLER source configuration (whose lane ids
            # name different rays here), so the ray count must match.
            lanes_np = np.asarray(lanes_np)
            if n_rays_ck is not None and n_rays_ck != n_rays:
                raise ValueError(
                    f"checkpoint was written for {n_rays_ck} rays but this "
                    f"run has {n_rays}; the source configuration differs"
                )
            if y_np.shape[-1] != lanes_np.shape[0]:
                raise ValueError(
                    f"corrupt checkpoint: state width {y_np.shape[-1]} != "
                    f"lane-map width {lanes_np.shape[0]}"
                )
            if not np.isin(lanes_np[lanes_np < n_rays], lane_to_ray).all():
                raise ValueError(
                    "checkpoint lane map is not a subset of this run's "
                    "lanes; the checkpoint was written with a different "
                    "compact_rootless setting or source configuration"
                )
            if lanes_np.size and int(lanes_np.max()) >= hist_w:
                raise ValueError(
                    "checkpoint was written under a mesh's padding; resume "
                    "with the same mesh configuration"
                )
            if mesh is not None and lanes_np.shape[0] % mesh.size:
                raise ValueError(
                    f"checkpoint lane count {lanes_np.shape[0]} does not "
                    f"divide over {mesh.size} mesh devices; resume with "
                    "the mesh it was written under")
            lane_to_ray = lanes_np
            n_lanes = lanes_np.shape[0]
            y = to_state(y_np, "y")
            t = to_state(t_np, "t")
            h = to_state(h_np, "h") if np.ndim(h_np) else None
        else:
            # Legacy checkpoint without a lane map: full width, sorted by
            # ray; mapped back to the current lane order.
            if y_np.shape[-1] != n_lanes:
                raise ValueError(
                    f"checkpoint lane count {y_np.shape[-1]} != {n_lanes}; "
                    "the checkpoint was written with a different "
                    "compact_rootless setting or source configuration"
                )
            rank = np.argsort(np.argsort(lane_to_ray))
            y = _take_lanes(to_state(y_np, "y"), rank)
            t = _take_lanes(to_state(t_np, "t"), rank)
            h = (_take_lanes(to_state(h_np, "h"), rank) if np.ndim(h_np)
                 else None)
        y = y.contiguous()
        if verbose:
            print(f"resumed from {checkpoint_path} at step {start}")

    if stream_dir:
        os.makedirs(stream_dir, exist_ok=True)

        def _alloc(k):
            path = os.path.join(stream_dir, f"{k}.npy")
            old = None
            if resuming and os.path.exists(path):
                try:
                    old = np.load(path, mmap_mode="r")
                except (ValueError, OSError):
                    old = None
                if old is not None and (old.ndim != 2
                                        or old.shape[1] != hist_w):
                    old = None
            m = np.lib.format.open_memmap(
                path + ".new", mode="w+", dtype=hist_dtype,
                shape=(nt, hist_w))
            m[:] = np.nan
            if old is not None:
                rows = min(old.shape[0], nt)
                m[:rows] = old[:rows]
                del old
            m.flush()
            # The mapping follows the inode, so the rename keeps m valid.
            os.replace(path + ".new", path)
            return m

        hist = {k: _alloc(k) for k in FIELDS}
    else:
        hist = {k: np.full((nt, hist_w), np.nan, hist_dtype) for k in FIELDS}
    for i, k in enumerate(FIELDS[:5]):
        hist[k][0, :n_rays] = y0_np[i]
    hist["ug"][0, :n_rays] = ug0_np
    hist["vg"][0, :n_rays] = vg0_np
    frozen = ~born0
    if compacted and config.integrator == "rk45":
        # The adaptive solver freezes rootless lanes at their seed state
        # forever (finite lon/lat/kx, NaN ky/amp/ug/vg); fill those rows up
        # front. RK4 NaNs them from step 1: the NaN prefill.
        for i, k in enumerate(FIELDS[:3]):
            hist[k][1:, :n_rays][:, frozen] = y0_np[i][frozen][None]

    # Checkpointed history rows (a streamed run keeps its history in the
    # stream_dir memmaps; its checkpoint carries no hist_* arrays).
    for k in hist_l:
        hist[k][: hist_l[k].shape[0]] = hist_l[k]

    def on_shards(call, *lanes):
        """``call(bg, *lanes)``, or over a mesh one call per shard of the
        per-lane tensors ``lanes``, gathered (every output is per lane)."""
        if mesh is None:
            return call(bg, *lanes)
        outs, r = _tracer._run_sharded(mesh, bg, lanes, call)
        return _tracer.gather_tree(outs, r, device)

    rk45 = config.integrator == "rk45"
    f = None
    if rk45:
        # The entry stage (one launch of the entry kernel on the card) at
        # the start and on resume: the FSAL carry f = rhs(y) at each ray's
        # own time, then carried from chunk to chunk, and the initial step
        # where the checkpoint holds none. A fresh run enters at t = 0, the
        # initial step's time. A resume without a saved h takes it at
        # t = 0, as the JAX driver does: the same launch's h where samples
        # do not depend on time, a second launch at t = 0 where they do.
        # The kill test's last position needs no carry: each unit starts
        # it at its entry state, the last saved one.
        h_entry, f = on_shards(
            lambda b, yy, tt: _tracer.entry_stage(b, yy, tt, rtol, atol),
            y, t)
        if h is None:
            h = (on_shards(lambda b, yy: _tracer.initial_step_sizes(
                b, yy, rtol, atol), y)
                 if resuming and ray_mod.timed(bg) else h_entry)
    elif h is None:
        h = torch.zeros(n_lanes, dtype=dtype, device=device)

    def resort():
        """Reorder lanes by current grid cell (stable; NaN lanes last)."""
        nonlocal y, t, h, f, lane_to_ray
        ylon, ylat = y[0].cpu().numpy(), y[1].cpu().numpy()
        w, hgt = bs.fields.shape[-3], bs.lat.shape[0]
        ix = np.floor((ylon % (2.0 * np.pi) - float(bs.lon[0])) / bs.dx)
        iy = np.floor((ylat - float(bs.lat[0])) / bs.dy)
        cell = np.clip(ix, 0, w - 1) * hgt + np.clip(iy, 0, hgt - 1)
        cell = np.where(np.isfinite(cell), cell, np.inf)
        order = np.argsort(cell, kind="stable")
        if np.array_equal(order, np.arange(n_lanes)):
            return
        lane_to_ray = lane_to_ray[order]
        y, t, h = (_take_lanes(a, order) for a in (y, t, h))
        if f is not None:
            f = _take_lanes(f, order)

    # Run-level death accounting (the reference's all-dead early exit):
    # "born" keys on the initial amplitude, since rootless lanes keep a
    # finite frozen position forever.
    n_born = int(born0.sum())
    born_ray = np.zeros(hist_w, dtype=bool)
    born_ray[:n_rays] = born0
    all_dead_at: Optional[int] = None

    split.lap("setup")
    progress = Progress(nt - 1) if verbose else None
    step = start
    chunks_done = 0
    while step < nt:
        if sort_rays:
            resort()
        n = min(chunk_steps, nt - step)
        run = None
        split.unit_start()
        if not rk45:
            # The carry is row step - 1, at model time (step - 1) * tstep.
            y, (ys, ugs, vgs) = on_shards(
                lambda b, yy: _tracer._rk4_chunk(
                    b, yy, dt, n, cut_off,
                    t_start=(step - 1) * config.tstep), y)
        else:
            bounds = torch.arange(step, step + n, dtype=dtype,
                                  device=device) * dt
            pin = (config.pin_limit,
                   None if config.pin_limit is None else config.pin_mwn)

            def unit(b, yy, row0, hh, ff, tt):
                """The chunk's unit over lanes entered at times tt; row 0
                of its output is their entry state and row0, the driver
                keeps rows 1..n."""
                bb = bounds.to(yy.device)
                if config.interval_batch == 1:
                    return _tracer._exact_run(
                        b, yy, row0, row0, hh, ff, bb[:, None], n, cut_off,
                        rtol, atol, min_step, BARRIER_MAX_ITERS,
                        barrier=True, t0=tt)
                args = (b, yy, row0, row0, hh, ff, bb[None], n, cut_off,
                        rtol, atol, min_step, MAX_ITERS)
                if config.bound_mode == "dense":
                    return _tracer._dense_run(*args, *pin, t0=tt)
                return _tracer._exact_run(*args, t0=tt)

            run = on_shards(unit, y, torch.zeros_like(t), h, f, t)
            y, t, h, f = run.carry[:4]
            ys, ugs, vgs = run.ys[1:], run.ugs[1:], run.vgs[1:]
        split.unit_end()
        ys, ugs, vgs = (a.cpu().numpy() for a in (ys, ugs, vgs))
        split.lap("d2h")
        if run is not None:
            if stats is not None:
                stats.setdefault("lane_att", []).append(run.lane_att)
            n_trunc = int(run.trunc.sum())
            if n_trunc:
                raise _tracer.MaxItersTruncation(
                    f"adaptive integration hit the max_iters backstop with "
                    f"{n_trunc} unfinished lane-group(s) in output steps "
                    f"{step}..{step + n - 1}; history would be silently "
                    "frozen mid-interval"
                    + (f"; {checkpoint_path} holds the run to step {step}"
                       if checkpoint_path else "")
                    + ". Arm the straggler pin-kill (pin_limit, pin_mwn=0) "
                    "in dense mode.")
        for i, k in enumerate(FIELDS[:5]):
            hist[k][step: step + n, lane_to_ray] = ys[:, i]
        hist["ug"][step: step + n, lane_to_ray] = ugs
        hist["vg"][step: step + n, lane_to_ray] = vgs
        split.lap("scatter")
        # Early exit keys on POSITION NaN, not amplitude: a born lane whose
        # amp overflowed to NaN while its position stayed finite is frozen
        # at a FINITE state that the uninterrupted run keeps emitting, so it
        # blocks the exit.
        born_lane = born_ray[lane_to_ray]
        fully_dead = (~np.isfinite(ys[:, 0]) | ~born_lane[None, :]).all(
            axis=1)
        if n_born > 0 and fully_dead[-1]:
            all_dead_at = step + int(np.argmax(fully_dead))
        step += n
        if progress:
            ray_steps = (n * n_lanes if run is None
                         else int(run.lane_att.sum()))
            progress.update(
                step - 1, ray_steps,
                alive_frac=np.isfinite(ys[-1, 4]).sum() / max(n_born, 1))
        if checkpoint_path:
            # The carry in ORIGINAL ray order, so resume is order-free.
            split.mark()
            inv = np.argsort(lane_to_ray)
            _save(
                checkpoint_path, step,
                y.cpu().numpy()[:, inv], t.cpu().numpy()[inv],
                h.cpu().numpy()[inv],
                # Streamed history is already durable in its own memmaps.
                {} if stream_dir else {k: v[:step] for k, v in hist.items()},
                lane_to_ray[inv], n_rays,
            )
            if stream_dir:
                for v in hist.values():
                    v.flush()
            split.lap("checkpoint")
        chunks_done += 1
        if (max_chunks is not None and chunks_done >= max_chunks
                and step < nt and all_dead_at is None):
            # The all-dead exit takes precedence: it COMPLETES the run (a
            # host-side tail fill), so never trade it for a resume.
            if not checkpoint_path:
                raise ValueError("max_chunks needs checkpoint_path")
            raise ChunkBudgetReached(step, nt)
        if all_dead_at is not None:
            # Every born ray is dead: the remaining history is determined
            # (NaN for dead rays; rootless lanes frozen at their seed
            # position in rk45, NaN in rk4), so stop and fill the tail.
            if frozen.any() and step < nt and rk45:
                for i, k in enumerate(FIELDS[:3]):
                    hist[k][step:, :n_rays][:, frozen] = (
                        y0_np[i][frozen][None])
            if verbose:
                print(f"\nall {n_born} born rays terminated by output step "
                      f"{all_dead_at}; stopping early")
            break
        if config.compact_dead and step < nt:
            # Mid-run dead-lane compaction (exact): a lane whose last
            # emitted position is NaN emits NaN at every remaining bound,
            # so it leaves the batch; its history rows are already the NaN
            # prefill. Lanes frozen at a FINITE state read as alive and stay.
            # The width shrinks along a power-of-two ladder with dead lanes
            # as filler.
            split.mark()
            alive = np.isfinite(ys[-1, 0])
            n_alive = int(alive.sum())
            target = max(1 << (max(n_alive, 1) - 1).bit_length(),
                         compact_min_width)
            if mesh is not None:
                target = -(-target // mesh.size) * mesh.size
            if target < n_lanes:
                keep = np.flatnonzero(alive)
                filler = np.flatnonzero(~alive)[: target - n_alive]
                kept = np.sort(np.concatenate([keep, filler]))
                lane_to_ray = lane_to_ray[kept]
                n_lanes = int(kept.shape[0])
                y, t, h = (_take_lanes(a, kept) for a in (y, t, h))
                if f is not None:
                    f = _take_lanes(f, kept)
                if verbose:
                    print(f"\ncompacted device batch to {n_lanes} lanes "
                          f"({n_alive} alive)")
            split.lap("compact")

    out_shape = (nt, 3, source_lon.shape[0], len(config.zwn))
    traj = _tracer.RayTrajectories(**{
        k: torch.from_numpy(hist[k][:, :n_rays].reshape(out_shape))
        for k in FIELDS})
    if verbose:
        from rwrt_tpu_torch.diagnostics import termination

        rep = termination.analyze(traj)
        print("termination summary: "
              + "  ".join(f"{k}={v}" for k, v in rep.counts.items()))
    return traj
