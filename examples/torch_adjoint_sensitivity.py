"""Adjoint sensitivity of ray trajectories to the background wind, on the
PyTorch/CUDA port (``adjoint_sensitivity.py`` on ``rwrt_tpu``).

``torch.autograd`` differentiates the whole pipeline -- basic-state
precompute, dispersion-root seeding, RK4 integration -- so questions like
"which jet perturbation steers this ray poleward?" are one reverse pass
instead of a finite-difference sweep per parameter. Gradients take the
port's plain, differentiable route (``solvers.rk4.trace`` over
``models.ray._rhs_core``; the hand-written kernels carry no gradients), on
the card or the host. See docs/DESIGN.md section 6f.

Run: PYTHONPATH=. python examples/torch_adjoint_sensitivity.py [--device cpu]
Runs on the CUDA card unless ``--device cpu`` is given (no card: an error).
"""


import numpy as np
import torch

import rwrt_tpu_torch as rt
from rwrt_tpu_torch.main import parse_device
from rwrt_tpu_torch import tracer
from rwrt_tpu_torch.solvers import rk4


def main(argv=None):
    device = parse_device(__doc__, argv)
    f64 = torch.float64

    def t64(x):
        return torch.as_tensor(x, dtype=f64, device=device)

    nlon, nlat = 72, 37
    lat = np.linspace(-np.pi / 2, np.pi / 2, nlat)
    lon = np.arange(nlon) * 2 * np.pi / nlon
    u0 = t64(20.0 * np.cos(lat)[None, :] ** 2
             + 25.0 * np.exp(-(((np.degrees(lat)[None, :] - 40.0) / 12.0)
                               ** 2))
             + 8.0 * np.cos(2 * lon)[:, None] * np.cos(lat)[None, :] ** 2)
    v0 = t64(3.0 * np.sin(lon)[:, None] * np.cos(lat)[None, :])

    def final_latitude(jet_scale, seed_lat):
        """Latitude (rad) of the first root's ray after 4 model days."""
        bs = rt.prepare(jet_scale * u0, v0, lat, lon, read_dtype=f64,
                        cal_dtype=f64, device=device)
        bg = tracer.make_background(bs, 0.0)
        y0, _, _ = tracer.initialize(bg, t64([0.3]), seed_lat.reshape(1),
                                     t64([4.0]))
        ys, _, _ = rk4.trace(bg, y0, 7200.0, 49, 0.2)
        return ys[-1, 1, 0]

    jet = t64(1.0).requires_grad_(True)
    seed = t64(0.25).requires_grad_(True)
    val = final_latitude(jet, seed)
    d_jet, d_seed = torch.autograd.grad(val, (jet, seed))

    # Check against central differences.
    eps = 1e-6
    with torch.no_grad():
        fd_jet = (final_latitude(t64(1.0 + eps), t64(0.25))
                  - final_latitude(t64(1.0 - eps), t64(0.25))) / (2 * eps)
        fd_seed = (final_latitude(t64(1.0), t64(0.25 + eps))
                   - final_latitude(t64(1.0), t64(0.25 - eps))) / (2 * eps)

    print(f"final latitude after 4 days: {np.degrees(float(val.detach())):.3f} deg")
    print(f"d(final lat)/d(jet scale):  grad {float(d_jet):+.8f}   "
          f"fd {float(fd_jet):+.8f}")
    print(f"d(final lat)/d(seed lat):   grad {float(d_seed):+.8f}   "
          f"fd {float(fd_seed):+.8f}")


if __name__ == "__main__":
    main()
