"""Differentiable source targeting: which seeds reach a target point?

Port of ``rwrt_tpu/diagnostics/targeting.py``. The WRF postprocessor
answers the question retrospectively (``diagnostics.flux.
region_statistics``: the wave sources of rays that reached a region);
here it is answered prospectively. Every step of prepare -> initialize ->
RK4 trace is plain PyTorch with the roots' implicit-function gradient
(``ops/cubic.py``), so the great-circle miss distance of a ray to a target
is a differentiable function of its seed position, and Adam moves the
seeds until their rays pass the target.

The forward model is the fixed-step RK4 path (``solvers/rk4.trace`` over
the plain ``models/ray._rhs_core``), on the device of the background: on
the card it runs as plain PyTorch ops, as the JAX package runs it as a
plain ``scan``. No hand-written kernel takes part (they refuse
gradient-carrying inputs, ``kernels.launch``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from rwrt_tpu_torch import tracer
from rwrt_tpu_torch.constants import pi
from rwrt_tpu_torch.models.basic_state import BasicState
from rwrt_tpu_torch.solvers import rk4


def _great_circle(lon, lat, lon0, lat0):
    """Central angle (radians) between (lon, lat) and the fixed point
    (lon0, lat0): the haversine form, stable for small separations."""
    sdlat = torch.sin(0.5 * (lat - lat0))
    sdlon = torch.sin(0.5 * (lon - lon0))
    h = sdlat * sdlat + torch.cos(lat) * torch.cos(lat0) * sdlon * sdlon
    return 2.0 * torch.arcsin(torch.sqrt(torch.clamp(h, 0.0, 1.0)))


def miss_distance(bg, source_lon, source_lat, zwn, target_lon, target_lat,
                  *, nt: int, dt, cut_off,
                  tau: Optional[float] = None) -> torch.Tensor:
    """Per-seed miss distance (radians) to the target, differentiable.

    Traces all 3 * nsource * nzwn rays with fixed-step RK4 and returns, for
    each of the nsource seeds, the minimum great-circle distance to
    (target_lon, target_lat) over every saved time, root slot and zonal
    wavenumber. A ray dead (NaN) at a time counts the maximum distance pi
    there, through a double where, so reverse-mode gradients stay finite.

    tau: None takes the hard min (the gradient follows the single closest
    point); a small tau (~0.05) the softmin -tau logsumexp(-d / tau), which
    smooths the objective over nearby times and roots.
    """
    zwn = torch.as_tensor(zwn, dtype=source_lon.dtype,
                          device=source_lon.device)
    y0, _, _ = tracer.initialize(bg, source_lon, source_lat, zwn)
    ys, _, _ = rk4.trace(bg, y0, dt, nt, cut_off)
    lon_t, lat_t = ys[:, 0], ys[:, 1]  # (nt, R)
    fin = torch.isfinite(lon_t) & torch.isfinite(lat_t)
    zero = torch.zeros_like(lon_t)
    lon_s = torch.where(fin, lon_t, zero)
    lat_s = torch.where(fin, lat_t, zero)
    d = _great_circle(lon_s, lat_s,
                      torch.as_tensor(target_lon, dtype=lon_s.dtype,
                                      device=lon_s.device),
                      torch.as_tensor(target_lat, dtype=lon_s.dtype,
                                      device=lon_s.device))
    d = torch.where(fin, d, torch.full_like(d, pi))
    nsource = source_lon.shape[0]
    d = d.reshape(nt, 3, nsource, zwn.shape[0])
    d = torch.movedim(d, 2, 0).reshape(nsource, -1)  # (nsource, nt*3*nzwn)
    if tau is None:
        return d.amin(dim=1)
    return -tau * torch.logsumexp(-d / tau, dim=1)


class TargetingResult(NamedTuple):
    source_lon: torch.Tensor  # (nsource,) optimized seed longitudes (rad)
    source_lat: torch.Tensor  # (nsource,) optimized seed latitudes (rad)
    miss: torch.Tensor        # (nsource,) final hard-min miss distance (rad)
    history: np.ndarray       # (steps + 1,) mean softmin objective per step


def optimize_seeds(bs: BasicState, source_lon, source_lat, zwn, target_lon,
                   target_lat, *, nt: int, dt: float = 7200.0,
                   cut_off: float = 0.2, freq: float = 0.0, steps: int = 80,
                   learning_rate: float = 0.02, tau: float = 0.05,
                   lat_bound: float = 1.4) -> TargetingResult:
    """Gradient-descend seed positions until their rays pass the target.

    Args:
      bs: prepared (static) basic state; the optimization runs on its
        device.
      source_lon, source_lat: initial seed positions (radians).
      zwn: zonal wavenumbers to seed (each seed traces 3 roots x nzwn rays
        and scores by its best ray).
      target_lon, target_lat: target point (radians).
      nt, dt, cut_off: forward-trace settings (fixed-step RK4).
      steps, learning_rate: Adam steps (optax's ``adam`` defaults: betas
        (0.9, 0.999), eps 1e-8) on the mean softmin miss distance.
      tau: softmin temperature (radians); see ``miss_distance``.
      lat_bound: seeds are clamped to |lat| <= lat_bound after each update
        (off the polar cap, where the background sample is masked).

    Returns a TargetingResult: the optimized positions, the final per-seed
    hard-min miss, and the objective before each update plus the final
    one (forward only).
    """
    if bs.fields.ndim == 4:
        raise ValueError("optimize_seeds expects a static background; take "
                         "one frame of a time-varying BasicState")
    dtype, device = bs.fields.dtype, bs.fields.device
    bg = tracer.make_background(bs, freq)
    slon, slat = (torch.as_tensor(x, dtype=dtype, device=device).detach()
                  .clone().requires_grad_(True)
                  for x in (source_lon, source_lat))
    kw = dict(nt=nt, dt=dt, cut_off=cut_off)

    def objective(lon, lat):
        return miss_distance(bg, lon, lat, zwn, target_lon, target_lat,
                             tau=tau, **kw).mean()

    opt = torch.optim.Adam([slon, slat], lr=learning_rate,
                           betas=(0.9, 0.999), eps=1e-8)
    history = []
    for _ in range(steps):
        opt.zero_grad(set_to_none=False)
        val = objective(slon, slat)
        val.backward()
        # A seed whose every ray is dead or rootless has zero gradient
        # through the double where; keep NaN out of Adam regardless.
        for p in (slon, slat):
            torch.nan_to_num_(p.grad)
        opt.step()
        with torch.no_grad():
            slon.copy_(torch.remainder(slon, 2.0 * pi))
            slat.clamp_(-lat_bound, lat_bound)
        history.append(float(val.detach()))  # the objective BEFORE the update
    with torch.no_grad():
        history.append(float(objective(slon, slat)))
        final = miss_distance(bg, slon, slat, zwn, target_lon, target_lat,
                              tau=None, **kw)
    return TargetingResult(source_lon=slon.detach(),
                           source_lat=slat.detach(), miss=final,
                           history=np.asarray(history))
