"""WRF_universal equivalent: the file-level Li-Yang wave-ray-flux driver.

Port of ``rwrt_tpu/diagnostics/wrf_cli.py``, the manual's (section 4) main
program over this framework's trajectory files (NetCDF or .npz, the
``write_trajectories`` schema of either package): load the ray-output
file(s), apply Fun1's thresholds, Fun2's target region, and compute Fun3's
WRF maps and region aggregates. The maps are binned on the card (the flux
kernel) unless ``--device cpu``; without a card a CUDA run is an error.

    python -m rwrt_tpu_torch.diagnostics.wrf_cli --traj traj.npz \\
        --out wrf.npz --lon-range 150 240 --lat-range 20 60 \\
        --speed-max 120 --mwn-max 100 [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from rwrt_tpu_torch.constants import deg2rad
from rwrt_tpu_torch.convert import host


def load_ray_output(path, device="cuda"):
    """Read trajectory file(s) (write_trajectories schema) into the
    RayTrajectories the diagnostics consume, on ``device``.

    A list of paths (e.g. the per-member files of a CLI ensemble run) is
    concatenated along the source axis, so every downstream diagnostic
    (flux maps, region statistics) aggregates over all members in one pass.

    device="cpu" keeps the history on the host: the memory-bounded
    (--time-block) path then copies only one block at a time to the card.
    """
    from rwrt_tpu_torch.io import ncio

    paths = [path] if isinstance(path, str) else list(path)
    return trajectories_from_files(
        [ncio.load_trajectories(p) for p in paths], device)


def trajectories_from_files(parts, device="cuda"):
    """The RayTrajectories of trajectory-file contents (dicts of the
    write_trajectories variables: rlon, rlat in degrees, ...), concatenated
    along the source axis, on ``device``."""
    from rwrt_tpu_torch.tracer import RayTrajectories

    shapes = {p["rlon"].shape[0:2] + p["rlon"].shape[3:4] for p in parts}
    if len(shapes) != 1:
        raise ValueError(
            "trajectory files must share (time, root, zwn) dims to be "
            f"aggregated, got {sorted(shapes)}"
        )

    def cat(key):
        return np.concatenate([p[key] for p in parts], axis=2)

    def conv(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return RayTrajectories(
        lon=conv(cat("rlon") * deg2rad),
        lat=conv(cat("rlat") * deg2rad),
        kx=conv(cat("rzwn")),
        ky=conv(cat("rmwn")),
        amp=conv(cat("ramp")),
        ug=conv(cat("rug")),
        vg=conv(cat("rvg")),
    )


def write_flux(wrf, path: str, stats=None, ens=None) -> str:
    """Write the flux maps (+ optional region aggregates) to .npz or NetCDF,
    with the JAX package's variables.

    ens: optional (mean, std) WaveRayFlux pair from
    flux.ensemble_flux_statistics; written as <field>_mean / <field>_std.

    Returns the path actually written (npz fallback appends '.npz')."""
    from rwrt_tpu_torch.io import ncio

    data = {
        "lon": host(wrf.lon_centers),
        "lat": host(wrf.lat_centers),
        "flux_u": host(wrf.flux_u),
        "flux_v": host(wrf.flux_v),
        "amp_sum": host(wrf.amp_sum),
        "count": host(wrf.count),
    }
    if ens is not None:
        e_mean, e_std = ens
        for field in ("flux_u", "flux_v", "amp_sum", "count"):
            data[f"{field}_mean"] = host(getattr(e_mean, field))
            data[f"{field}_std"] = host(getattr(e_std, field))
    if stats is not None:
        data.update({
            "n_passing": np.asarray(stats.n_passing),
            "mean_entry_time": np.asarray(stats.mean_entry_time),
            "mean_speed": np.asarray(stats.mean_speed),
            "source_lon": np.asarray(stats.source_lon),
            "source_lat": np.asarray(stats.source_lat),
            "first_entry_step": np.asarray(stats.first_entry_step),
        })
    if str(path).endswith(".npz") or not ncio.HAVE_NETCDF:
        if not str(path).endswith(".npz"):
            path = str(path) + ".npz"
        np.savez_compressed(path, **data)
        return str(path)
    import netCDF4 as _nc  # pragma: no cover - environment dependent

    with _nc.Dataset(path, "w", format="NETCDF4") as ds:
        ds.createDimension("lon", data["lon"].shape[0])
        ds.createDimension("lat", data["lat"].shape[0])
        ds.createVariable("lon", "f8", ("lon",))[:] = data["lon"]
        ds.createVariable("lat", "f8", ("lat",))[:] = data["lat"]
        map_names = ["flux_u", "flux_v", "amp_sum", "count"]
        if ens is not None:
            map_names += [f"{f}_{s}" for f in map_names[:4]
                          for s in ("mean", "std")]
        for name in map_names:
            ds.createVariable(name, "f8", ("lon", "lat"),
                              zlib=True, complevel=4)[:] = data[name]
        if stats is not None:
            fes = data["first_entry_step"]
            nroot, nsource, nzwn = fes.shape
            np_ = data["source_lon"].shape[0]
            # size 0 must be an unlimited dim (fixed netCDF dims cannot be
            # empty), so readers see empty arrays, as from the .npz branch.
            for dim, n in (("root", nroot), ("source", nsource),
                           ("zwn", nzwn), ("passing", np_ or None)):
                ds.createDimension(dim, n)
            ds.createVariable("first_entry_step", "i4",
                              ("root", "source", "zwn"))[:] = fes
            v_lon = ds.createVariable("source_lon", "f8", ("passing",))
            v_lat = ds.createVariable("source_lat", "f8", ("passing",))
            if np_:
                v_lon[:] = data["source_lon"]
                v_lat[:] = data["source_lat"]
            ds.n_passing = int(stats.n_passing)
            ds.mean_entry_time = float(stats.mean_entry_time)
            ds.mean_speed = float(stats.mean_speed)
    return str(path)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="rwrt_tpu_torch.wrf",
        description="Li-Yang wave-ray flux over a trajectory file "
                    "(WRF_universal equivalent; manual section 4), binned "
                    "on a CUDA card (PyTorch port)",
    )
    ap.add_argument("--traj", required=True, nargs="+",
                    help="trajectory file(s) (nc/npz); several files (e.g. "
                         "an ensemble's per-member outputs) aggregate into "
                         "one set of flux maps/statistics")
    ap.add_argument("--out", required=True, help="output flux file (nc/npz)")
    ap.add_argument("--nlon-bins", type=int, default=360)
    ap.add_argument("--nlat-bins", type=int, default=90)
    ap.add_argument("--weight", default="amp_cg",
                    choices=("count", "cg", "amp_cg"))
    # Fun1's optional thresholds.
    ap.add_argument("--speed-min", type=float, default=None,
                    help="truncation group-speed lower bound (m/s)")
    ap.add_argument("--speed-max", type=float, default=None,
                    help="truncation group-speed upper bound (m/s)")
    ap.add_argument("--mwn-max", type=float, default=None,
                    help="drop points with |meridional wavenumber| >= this")
    ap.add_argument("--amp-min", type=float, default=0.0)
    ap.add_argument("--amp-max", type=float, default=float("inf"))
    # Fun2's target region.
    ap.add_argument("--lon-range", type=float, nargs=2, default=None)
    ap.add_argument("--lat-range", type=float, nargs=2, default=None)
    ap.add_argument("--tstep", type=float, default=7200.0,
                    help="output cadence of the trajectory file (s), for "
                         "the region aggregates")
    ap.add_argument("--ensemble-stats", action="store_true",
                    help="with several --traj files, also write the "
                         "per-member ensemble mean and inter-member std of "
                         "every flux map (<field>_mean / <field>_std)")
    ap.add_argument("--time-block", type=int, default=None,
                    help="bin the maps in time blocks of this many output "
                         "steps (bounded device memory for very long "
                         "histories; equal to the one-shot result)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the maps are binned (default: the CUDA "
                         "card; a run on a machine without one is an "
                         "error)")
    args = ap.parse_args(argv)

    from rwrt_tpu_torch.diagnostics import flux as flux_mod

    if args.time_block is not None and args.time_block < 1:
        ap.error("--time-block must be >= 1")
    if args.ensemble_stats and len(args.traj) < 2:
        ap.error("--ensemble-stats needs at least two --traj files")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available for this run; pass --device cpu "
            "to bin on the host")
    flux_kw = dict(
        nlon_bins=args.nlon_bins, nlat_bins=args.nlat_bins,
        amp_min=args.amp_min, amp_max=args.amp_max,
        speed_min=args.speed_min, speed_max=args.speed_max,
        mwn_max=args.mwn_max,
        lon_range=args.lon_range, lat_range=args.lat_range,
        weight=args.weight,
    )
    # The time-blocked path keeps the history on the host and copies one
    # block at a time to the device.
    load_on = "cpu" if args.time_block else device

    def bin_maps(t):
        if args.time_block:
            return flux_mod.wave_ray_flux_chunked(
                t, time_block=args.time_block, device=device, **flux_kw)
        return flux_mod.wave_ray_flux(t, **flux_kw)

    ens = None
    if args.ensemble_stats:
        # Load each member once; the pooled maps are n x the member mean
        # (the pooled aggregation is the member sum by construction).
        members = [load_ray_output(p, device=load_on) for p in args.traj]
        ens = flux_mod.ensemble_flux_statistics(
            members, time_block=args.time_block, device=device, **flux_kw)
        n = len(members)
        e_mean = ens[0]
        wrf = type(e_mean)(
            lon_centers=e_mean.lon_centers, lat_centers=e_mean.lat_centers,
            flux_u=e_mean.flux_u * n, flux_v=e_mean.flux_v * n,
            amp_sum=e_mean.amp_sum * n, count=e_mean.count * n,
        )
        traj = None  # only assembled if the region aggregates need it
    else:
        members = None
        traj = load_ray_output(args.traj, device=load_on)
        wrf = bin_maps(traj)
    stats = None
    if args.lon_range is not None and args.lat_range is not None:
        if traj is None:
            from rwrt_tpu_torch.tracer import RayTrajectories

            traj = RayTrajectories(**{
                k: np.concatenate([host(getattr(m, k)) for m in members],
                                  axis=2)
                for k in ("lon", "lat", "kx", "ky", "amp", "ug", "vg")
            })
        stats = flux_mod.region_statistics(
            traj, args.lon_range, args.lat_range, args.tstep,
            time_block=args.time_block)

        def _num(x, digits):
            return round(float(x), digits) if np.isfinite(x) else None

        print(json.dumps({
            "n_passing": int(stats.n_passing),
            "mean_entry_time_h": _num(stats.mean_entry_time / 3600.0, 2),
            "mean_speed_m_s": _num(stats.mean_speed, 2),
        }))
    written = write_flux(wrf, args.out, stats, ens=ens)
    points = int(host(wrf.count).sum(dtype=np.float64))
    print(f"wrote {written}: {points} points binned on "
          f"({args.nlon_bins}, {args.nlat_bins})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
