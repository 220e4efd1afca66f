"""Li-Yang wave-ray flux diagnostics demo on the PyTorch/CUDA port
(``flux_diagnostics_demo.py`` on ``rwrt_tpu``; BASELINE.json config 5
shape): trace an ensemble of rays over a jet background, then accumulate
the amplitude-weighted group-velocity flux on the -360..720-degree
diagnostic grid, restricted to rays that reach a target region.

Run: PYTHONPATH=. python examples/torch_flux_diagnostics_demo.py [--device cpu]
Runs on the CUDA card unless ``--device cpu`` is given (no card: an error).
"""

import os

import numpy as np
import torch

import rwrt_tpu_torch as rt
from rwrt_tpu_torch.main import parse_device
from rwrt_tpu_torch.config import RunConfig
from rwrt_tpu_torch.diagnostics import (
    compute_wavenumber_maps,
    region_statistics,
    wave_ray_flux,
)
from rwrt_tpu_torch.diagnostics.termination import analyze

HOUR, DAY = 3600.0, 86400.0
# RWRT_SMOKE=1 shrinks the run so CI can exercise this script end to end.
SMOKE = os.environ.get("RWRT_SMOKE") == "1"


def jet_background(nlon=144, nlat=73):
    lat = np.linspace(-np.pi / 2, np.pi / 2, nlat)
    lon = np.arange(nlon) * 2 * np.pi / nlon
    u = (
        22.0 * np.cos(lat)[None, :] ** 2
        + 28.0 * np.exp(-(((np.degrees(lat)[None, :] - 38.0) / 11.0) ** 2))
        + 5.0 * np.cos(2 * lon)[:, None] * np.cos(lat)[None, :] ** 2
    )
    v = 3.0 * np.sin(lon)[:, None] * np.cos(lat)[None, :]
    return u, v, lat, lon


def main(argv=None):
    device = parse_device(__doc__, argv)
    u, v, lat, lon = jet_background(*((72, 37) if SMOKE else (144, 73)))
    bs = rt.prepare(u, v, lat, lon, cal_dtype="float32", device=device)

    cfg = RunConfig(
        zwn=(3.0, 4.0) if SMOKE else (1.0, 2.0, 3.0, 4.0, 5.0),
        sw_lon=0.0, sw_lat=10.0, dlon=20.0, dlat=5.0,
        nnx=6 if SMOKE else 18, nny=3 if SMOKE else 7,
        tstep=2 * HOUR, ttotal=(3 if SMOKE else 20) * DAY, integrator="rk45",
    )
    traj = rt.trace_rays(bs, cfg)

    # Full-globe flux accumulation.
    wrf = wave_ray_flux(traj, nlon_bins=216, nlat_bins=72, amp_min=1e-3)
    # Target-region selection: rays reaching the North Pacific box.
    wrf_box = wave_ray_flux(
        traj, nlon_bins=216, nlat_bins=72,
        lon_range=(150.0, 240.0), lat_range=(20.0, 60.0),
    )

    rep = analyze(traj)
    maps = compute_wavenumber_maps(bs, np.asarray(cfg.zwn))

    total = wrf.count.sum().item()
    boxed = wrf_box.count.sum().item()
    print(f"trajectory points binned: {int(total):,} "
          f"(region-filtered: {int(boxed):,})")
    print("termination counts:", rep.counts)
    flux_u = wrf.flux_u.cpu().numpy()
    print("zonal flux extrema:", float(flux_u.min()), float(flux_u.max()))
    print("propagating-root fraction per zwn:",
          np.round(np.mean(maps.rootnum.cpu().numpy() > 0, axis=(0, 1)), 3))

    # Fun3 extras (manual section 4): aggregates over rays that reach the box.
    stats = region_statistics(traj, (150.0, 240.0), (20.0, 60.0), cfg.tstep)
    if stats.n_passing:
        print(f"rays reaching the box: {stats.n_passing}, mean arrival "
              f"{stats.mean_entry_time / DAY:.1f} d, mean along-path speed "
              f"{stats.mean_speed:.1f} m/s, sources spanning "
              f"{np.degrees(stats.source_lon.min()):.0f}-"
              f"{np.degrees(stats.source_lon.max()):.0f}E")
    else:
        print("no rays reach the target box")


if __name__ == "__main__":
    main()
