"""Differentiable source targeting demo on the PyTorch/CUDA port
(``source_targeting.py`` on ``rwrt_tpu``): gradient-descend seed positions
until their rays pass a target point.

The forward pipeline (basic-state precompute -> dispersion-root seeding ->
RK4 trace) is differentiable end to end (docs/DESIGN.md section 6f), so the
great-circle miss distance of a ray to a target is a smooth function of its
seed position; ``diagnostics.targeting.optimize_seeds`` runs Adam
(``torch.optim.Adam``) on the softmin miss distance, on the device of the
basic state. The retrospective counterpart is the WRF postprocessor's
wave-source accounting (diagnostics/flux.py region_statistics).

Run: PYTHONPATH=. python examples/torch_source_targeting.py [--device cpu]
Runs on the CUDA card unless ``--device cpu`` is given (no card: an error).
"""

import os

import numpy as np
import torch

import rwrt_tpu_torch as rt
from rwrt_tpu_torch.main import parse_device
from rwrt_tpu_torch.diagnostics import targeting

# RWRT_SMOKE=1 shrinks the run so CI can exercise this script end to end.
SMOKE = os.environ.get("RWRT_SMOKE") == "1"


def jet_background(nlon=96, nlat=49):
    """Solid-body super-rotation: stationary rays follow great circles, so
    the optimizer's answer is checkable against spherical geometry."""
    lat = np.linspace(-np.pi / 2, np.pi / 2, nlat)
    lon = np.arange(nlon) * 2 * np.pi / nlon
    u = 30.0 * np.cos(lat)[None, :] * np.ones((nlon, 1))
    v = np.zeros((nlon, nlat))
    return u, v, lat, lon


def main(argv=None):
    device = parse_device(__doc__, argv)
    u, v, lat, lon = jet_background()
    bs = rt.prepare(u, v, lat, lon, cal_dtype="float64", device=device)

    target_lon, target_lat = np.radians(120.0), np.radians(35.0)
    seeds_lon = np.radians([10.0, 20.0, 340.0])
    seeds_lat = np.radians([5.0, 8.0, -4.0])
    steps = 12 if SMOKE else 60

    res = targeting.optimize_seeds(
        bs, seeds_lon, seeds_lat, (4.0,), target_lon, target_lat,
        nt=121, steps=steps, learning_rate=0.03,
    )

    print(f"objective: {res.history[0]:.4f} -> {res.history[-1]:.4f} rad "
          f"after {steps} Adam steps")
    for i in range(len(seeds_lon)):
        print(
            f"seed {i}: ({np.degrees(seeds_lon[i]):7.2f}, "
            f"{np.degrees(seeds_lat[i]):6.2f}) deg -> "
            f"({np.degrees(float(res.source_lon[i])):7.2f}, "
            f"{np.degrees(float(res.source_lat[i])):6.2f}) deg, "
            f"miss {np.degrees(float(res.miss[i])):.3f} deg"
        )


if __name__ == "__main__":
    main()
