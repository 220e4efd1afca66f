"""End-to-end run driver: the file-driven pipeline.

Port of ``rwrt_tpu/main.py``: load the background wind, build the basic
state (optionally regridded and SHSF-smoothed at ingest), write the
basic-state diagnostics file, seed the source matrix, trace the rays
(``trace_rays``, ``trace_rays_chunked`` or, for a list of wind files,
``trace_rays_ensemble``), and write the trajectory file, the optional
wavenumber maps and the optional JSON run report (with exact death causes,
``termination.classify``, where asked). The run goes to the card unless
``device="cpu"``; without a card a CUDA run is an error, never a silent run
on the host. ``mesh`` (the CLI's ``--mesh``) splits the rays over a mesh
of devices (``parallel.sharding``).
"""

from __future__ import annotations

import dataclasses
import json
import os
import platform
import time
from typing import Optional

import numpy as np
import torch

from rwrt_tpu_torch.config import RunConfig
from rwrt_tpu_torch.convert import host
from rwrt_tpu_torch.io import ncio
from rwrt_tpu_torch.models.basic_state import (prepare, prepare_time_varying,
                                               regrid_to_uniform)
from rwrt_tpu_torch.parallel import sharding
from rwrt_tpu_torch.tracer import RayTrajectories, trace_rays
from rwrt_tpu_torch.utils.checkpoint import trace_rays_chunked
from rwrt_tpu_torch.utils.observability import run_banner


@dataclasses.dataclass(frozen=True)
class RunPaths:
    """File paths.

    inputuv may be a list of wind files: that selects an ensemble sweep
    (one member per file). Per-member output paths are derived from
    bsfile/ncfile via a ``{member}`` placeholder, or an ``_m{i:03d}`` suffix
    before the extension when no placeholder is given.
    """

    inputuv: str              # background wind (nc or npz), or list of them
    bsfile: Optional[str] = None   # basic-state diagnostics output
    ncfile: Optional[str] = None   # trajectory output


def _load_and_prepare(inputuv: str, config: RunConfig, device):
    """Load one wind file and build its (static or time-varying) BasicState
    on ``device``."""
    u, v, lat, lon, times = ncio.load_wind(
        inputuv, config.read_dtype, with_time=True)
    if config.regrid:
        # Ingest-time regrid for Gaussian/regional source grids that
        # `prepare` refuses; 3-D winds frame by frame.
        if u.ndim == 3:
            frames = [regrid_to_uniform(u[i], v[i], lat, lon)
                      for i in range(u.shape[0])]
            u = np.stack([f[0] for f in frames]).astype(u.dtype)
            v = np.stack([f[1] for f in frames]).astype(v.dtype)
            lat, lon = frames[0][2], frames[0][3]
        else:
            dtype = u.dtype
            u, v, lat, lon = regrid_to_uniform(u, v, lat, lon)
            u = u.astype(dtype)
            v = v.astype(dtype)
    if config.shsf_truncation is not None:
        # Ingest-time spherical-harmonic smoothing on the run's device, in
        # the input's dtype; time frames pass straight through.
        from rwrt_tpu_torch.diagnostics.spectral import shsf

        u, v = (host(shsf(x, lat, config.shsf_truncation, config.shsf_mode,
                          device=device))
                for x in (u, v))
    if u.ndim == 3:
        # Time-varying background: frame cadence from the config, else from
        # the file's time variable (seconds).
        if config.bg_dt > 0:
            bg_t0, bg_dt = config.bg_t0, config.bg_dt
        else:
            if times is None or len(times) < 2:
                raise ValueError(
                    f"{inputuv} holds {u.shape[0]} wind frames but no "
                    "usable time variable; set bg_dt (and optionally bg_t0) "
                    "in the config, in seconds"
                )
            steps = np.diff(times)
            if not np.allclose(steps, steps[0], rtol=1e-6):
                raise ValueError(
                    "input time variable is not uniformly spaced; "
                    "set bg_dt explicitly"
                )
            bg_t0, bg_dt = float(times[0]), float(steps[0])
        return prepare_time_varying(
            u, v, lat, lon, bg_t0=bg_t0, bg_dt=bg_dt, xcyclic=config.xcyclic,
            read_dtype=config.read_dtype, cal_dtype=config.cal_dtype,
            device=device,
        )
    return prepare(
        u, v, lat, lon, xcyclic=config.xcyclic,
        read_dtype=config.read_dtype, cal_dtype=config.cal_dtype,
        device=device,
    )


def _member_path(template: Optional[str], i: int) -> Optional[str]:
    """Per-member output path: {member} placeholder or _m{i:03d} suffix."""
    if template is None:
        return None
    if "{member}" in template:
        return template.format(member=i)
    root, ext = os.path.splitext(str(template))
    return f"{root}_m{i:03d}{ext}"


def _report_skeleton(config: RunConfig, paths: RunPaths,
                     device: torch.device, mesh) -> dict:
    """Common header of the machine-readable run report."""
    import rwrt_tpu_torch

    cuda = device.type == "cuda"
    return {
        "framework": "rwrt_tpu_torch",
        "version": getattr(rwrt_tpu_torch, "__version__", "unknown"),
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "backend": device.type,
        "device_name": (torch.cuda.get_device_name(device) if cuda
                        else platform.processor() or platform.machine()),
        "n_devices": torch.cuda.device_count() if cuda else 1,
        "mesh": None if mesh is None else mesh.shape,
        "started_utc": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "config": dataclasses.asdict(config),
        "paths": dataclasses.asdict(paths),
    }


def _traj_summary(traj: RayTrajectories, config: RunConfig,
                  bs=None) -> dict:
    """Termination accounting + shape summary of one trajectory set.

    With a basic state, death causes are exact (``termination.classify``
    re-runs each killing interval in one batch on the state's device);
    otherwise they are the coarse host-side heuristic
    (``termination.analyze``).
    """
    from rwrt_tpu_torch.diagnostics.termination import analyze, classify

    rep = classify(traj, bs, config) if bs is not None else analyze(traj)
    shape = list(traj.lon.shape)
    return {
        "nt": shape[0],
        "shape": shape,
        "n_rays": int(np.prod(shape[1:])),
        "termination": rep.counts,
        "termination_causes": "exact" if bs is not None else "heuristic",
        "final_alive_frac": float(rep.alive_frac[-1]),
    }


def _write_report(report: dict, path: str, verbose: bool) -> None:
    tmp = f"{path}.tmp"
    with open(tmp, "w") as fh:
        json.dump(report, fh, indent=2)
    os.replace(tmp, path)
    if verbose:
        print(f"wrote run report to {path}")


def _finish_report(report: dict, path: str, verbose: bool,
                   grid: dict, wall: dict) -> None:
    """Common tail of the run report (single runs and ensembles alike)."""
    report["grid"] = grid
    report["wall_s"] = {k: round(v, 4) for k, v in wall.items()}
    _write_report(report, path, verbose)


def _clock(device: torch.device) -> float:
    """The host clock after the device's queued work: the wall split's
    phases end where their work ends, not where it was enqueued."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def _run_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available for this run; pass device='cpu' "
            "(--device cpu) to run on the host")
    return device


def run(config: RunConfig, paths: RunPaths, *, mesh=None, verbose: bool = True,
        chunked: bool = False, checkpoint_path: Optional[str] = None,
        wnmaps_path: Optional[str] = None,
        report_path: Optional[str] = None,
        report_exact_causes: bool = False, device="cuda"):
    """Execute the full pipeline on ``device`` (default: the card).

    wnmaps_path: also write the grid-wide wavenumber diagnostics there,
    reusing the basic state this run already prepared.
    report_path: write a machine-readable JSON run report there (config
    echo, torch/CUDA versions and the device, phase wall-clock split
    prepare / trace / io / total, termination accounting).
    report_exact_causes: death causes in the report come from
    ``termination.classify`` (one batched re-run of every killing interval,
    after the wall split ends) instead of the host heuristic.
    mesh: a ``parallel.sharding.Mesh`` of ``device``'s type, or True to
    build one over config.mesh_devices devices of that type (None: every
    card; one entry of the CPU), before anything is loaded; the report's
    "mesh" is then {"rays": shards}.

    With a list-valued paths.inputuv the run is an ensemble sweep: one
    member per file, per-member output files, and the return value is the
    list of per-member trajectories.
    """
    config.validate()
    device = _run_device(device)
    if mesh is True:
        mesh = sharding.make_mesh(config.mesh_devices, device.type)
    mesh = sharding.check_mesh(mesh, device)
    if isinstance(paths.inputuv, (list, tuple)):
        return _run_ensemble(config, paths, mesh=mesh, verbose=verbose,
                             chunked=chunked, checkpoint_path=checkpoint_path,
                             wnmaps_path=wnmaps_path, report_path=report_path,
                             report_exact_causes=report_exact_causes,
                             device=device)
    report = (_report_skeleton(config, paths, device, mesh) if report_path
              else None)
    t_start = time.perf_counter()
    bs = _load_and_prepare(paths.inputuv, config, device)
    t_prepare = _clock(device)
    if paths.bsfile:
        ncio.write_basic_state(bs, paths.bsfile)
    if verbose:
        run_banner(config, bs.nlon, bs.nlat)
    if chunked or checkpoint_path:
        traj = trace_rays_chunked(bs, config, checkpoint_path=checkpoint_path,
                                  verbose=verbose, mesh=mesh)
    else:
        traj = trace_rays(bs, config, mesh=mesh)
    t_trace = _clock(device)
    if paths.ncfile:
        ncio.write_trajectories(traj, paths.ncfile, config.zwn_array())
    if wnmaps_path:
        from rwrt_tpu_torch.diagnostics import compute_wavenumber_maps

        zwn = config.zwn_array()
        maps = compute_wavenumber_maps(bs, zwn, freq=config.freq, mesh=mesh)
        ncio.write_wavenumber_maps(maps, bs, zwn, wnmaps_path)
        if verbose:
            print(f"wrote wavenumber maps to {wnmaps_path}")
    if report is not None:
        t_end = _clock(device)
        report["trajectories"] = _traj_summary(
            traj, config, bs if report_exact_causes else None)
        _finish_report(
            report, report_path, verbose,
            grid={"nlon": int(bs.nlon), "nlat": int(bs.nlat),
                  "time_varying": bool(bs.fields.ndim == 4)},
            wall={"prepare": t_prepare - t_start,
                  "trace": t_trace - t_prepare,
                  "io": t_end - t_trace,
                  "total": t_end - t_start},
        )
    return traj


def _run_ensemble(config: RunConfig, paths: RunPaths, *, mesh, verbose,
                  chunked, checkpoint_path, wnmaps_path, report_path,
                  report_exact_causes, device):
    """Ensemble sweep over a list of input wind files.

    The fused path runs all members in one ``trace_rays_ensemble`` (one
    launch on the card); with chunked/checkpoint_path the members run one
    after another through the chunked driver instead (bounded device
    memory, per-member checkpoint files, resumable member by member).
    """
    if wnmaps_path:
        raise ValueError(
            "wnmaps is a single-background diagnostic; compute it per "
            "member via compute_wavenumber_maps"
        )
    from rwrt_tpu_torch.tracer import trace_rays_ensemble

    report = (_report_skeleton(config, paths, device, mesh) if report_path
              else None)
    n_members = len(paths.inputuv)
    grid0 = None  # (nlon, nlat, fields_ndim) of member 0

    def _check_member(m, i):
        nonlocal grid0
        if grid0 is None:
            grid0 = (m.nlon, m.nlat, m.fields.ndim)
            if verbose:
                run_banner(config, m.nlon, m.nlat)
                print(f"ensemble sweep: {n_members} members")
        else:
            if (m.nlon, m.nlat) != grid0[:2]:
                raise ValueError(
                    f"ensemble members must share one grid shape: member "
                    f"{i} is {(m.nlon, m.nlat)}, member 0 is {grid0[:2]}"
                )
            if m.fields.ndim != grid0[2]:
                raise ValueError(
                    "ensemble members must be all static or all "
                    "time-varying (mixed 2-D and 3-D input winds)"
                )
        bsfile = _member_path(paths.bsfile, i)
        if bsfile:
            ncio.write_basic_state(m, bsfile)

    t_start = time.perf_counter()
    member_reports = []
    if chunked or checkpoint_path:
        # Members are prepared one at a time INSIDE the loop, so only one
        # member's field stack is on the device at a time.
        trajs = []
        prepare_s = 0.0
        for i, p in enumerate(paths.inputuv):
            t0 = time.perf_counter()
            m = _load_and_prepare(p, config, device)
            prepare_s += _clock(device) - t0
            _check_member(m, i)
            if verbose:
                print(f"member {i}/{n_members} (chunked)")
            traj = trace_rays_chunked(
                m, config, checkpoint_path=_member_path(checkpoint_path, i),
                verbose=verbose, mesh=mesh)
            trajs.append(traj)
            if report is not None:
                member_reports.append(_traj_summary(
                    traj, config, m if report_exact_causes else None))
        t_trace = _clock(device)
        t_prepare = t_start + prepare_s  # prepare time interleaves the loop
    else:
        members = [_load_and_prepare(p, config, device)
                   for p in paths.inputuv]
        t_prepare = _clock(device)
        for i, m in enumerate(members):
            _check_member(m, i)
        trajs = trace_rays_ensemble(members, config, mesh=mesh)
        t_trace = _clock(device)
        if report is not None:
            member_reports = [
                _traj_summary(t, config, m if report_exact_causes else None)
                for t, m in zip(trajs, members)]
    for i, traj in enumerate(trajs):
        ncfile = _member_path(paths.ncfile, i)
        if ncfile:
            ncio.write_trajectories(traj, ncfile, config.zwn_array())
            if verbose:
                print(f"wrote member {i} trajectories to {ncfile}")
    if report is not None:
        t_end = _clock(device)
        report["n_members"] = n_members
        report["members"] = member_reports
        _finish_report(
            report, report_path, verbose,
            grid={"nlon": int(grid0[0]), "nlat": int(grid0[1]),
                  "time_varying": bool(grid0[2] == 4)},
            wall={"prepare": t_prepare - t_start,
                  "trace": t_trace - t_prepare,
                  "io": t_end - t_trace,
                  "total": t_end - t_start},
        )
    return trajs
