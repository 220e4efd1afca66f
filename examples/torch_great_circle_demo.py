"""Great-circle acceptance demo on the PyTorch/CUDA port (the reference
manual's example, section 2; ``great_circle_demo.py`` on ``rwrt_tpu``):
ideal super-rotation flow, zonal wavenumbers 1-5, 30-day integration,
sources at 0E / 0-20N every 5 degrees. Stationary-wave rays should trace
great circles (Hoskins & Karoly 1981).

Run: PYTHONPATH=. python examples/torch_great_circle_demo.py [--device cpu]
Runs on the CUDA card unless ``--device cpu`` is given (no card: an error).
Writes rays_great_circle.npz in the working directory.
"""

import os

import numpy as np
import torch

import rwrt_tpu_torch as rt
from rwrt_tpu_torch.main import parse_device
from rwrt_tpu_torch.config import RunConfig
from rwrt_tpu_torch.io import ncio

HOUR, DAY = 3600.0, 86400.0
# RWRT_SMOKE=1 shrinks the run so CI can exercise this script end to end.
SMOKE = os.environ.get("RWRT_SMOKE") == "1"


def ideal_flow(nlon=144, nlat=73, u0=15.0):
    """Solid-body super-rotation: u = U0 cos(lat), v = 0."""
    lat = np.linspace(-np.pi / 2, np.pi / 2, nlat)
    lon = np.arange(nlon) * 2 * np.pi / nlon
    u = u0 * np.cos(lat)[None, :] * np.ones((nlon, 1))
    v = np.zeros((nlon, nlat))
    return u, v, lat, lon


def main(argv=None):
    device = parse_device(__doc__, argv)
    u, v, lat, lon = ideal_flow(*((72, 37) if SMOKE else (144, 73)))
    bs = rt.prepare(u, v, lat, lon, cal_dtype="float32", device=device)

    cfg = RunConfig(
        zwn=(3.0,) if SMOKE else (1.0, 2.0, 3.0, 4.0, 5.0),
        sw_lon=0.0, sw_lat=0.0, dlon=1.0, dlat=5.0, nnx=1, nny=5,
        tstep=2 * HOUR, ttotal=(3 if SMOKE else 30) * DAY,
        integrator="rk45",
    )
    traj = rt.trace_rays(bs, cfg)
    ncio.write_trajectories(traj, "rays_great_circle.npz", cfg.zwn_array())

    lon_t = traj.lon.cpu().numpy()
    lat_t = traj.lat.cpu().numpy()
    alive = np.isfinite(lon_t[-1]).sum()
    print(f"integrated {lon_t.shape} trajectories; {alive} alive at end")
    print("max |lat| reached per zwn (deg):",
          np.round(np.degrees(np.nanmax(np.abs(lat_t), axis=(0, 1, 2))), 1))


if __name__ == "__main__":
    main()
