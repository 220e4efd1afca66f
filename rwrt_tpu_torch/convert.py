"""Carry state across between numpy and the port's tensors.

``host`` brings a tensor (any device) back as numpy, the one way the
writers, the accounting and the host root solver read device data. The JAX
package's ``BasicState``, ``Background`` and ``RayTrajectories`` are
NamedTuples of arrays; ``{k: np.asarray(v) for k, v in
state._asdict().items()}`` turns one into a mapping of numpy arrays and
scalars, and these functions build the port's counterpart from it. That
lets a test hold the port's tracer and diagnostics against the JAX package
on the very same inputs; ``flux_to_numpy`` brings the port's flux maps
back.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from rwrt_tpu_torch.models.basic_state import BasicState, as_dtype
from rwrt_tpu_torch.models.ray import Background
from rwrt_tpu_torch.solvers.rk45 import as_scalar
from rwrt_tpu_torch.tracer import RayTrajectories


def host(x, dtype=None) -> np.ndarray:
    """A tensor (any device) or array as numpy, without a copy where it
    can: CPU tensors (memmap-backed ones included) share their memory; a
    CUDA tensor is copied to the host. ``dtype`` converts on the host."""
    if torch.is_tensor(x):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype)


def _tensor(a, device, dtype):
    return torch.as_tensor(np.array(a)).to(device=device, dtype=dtype)


def basic_state_from_numpy(d: Mapping, *, device="cuda",
                           dtype=None) -> BasicState:
    """A port ``BasicState`` from a mapping shaped like the JAX one.

    ``fields``, ``lon``, ``lat``, ``betam``, ``ks`` and ``q`` are arrays;
    ``xcyclic``, ``bg_t0`` and ``bg_dt`` scalars. ``dtype`` defaults to the
    dtype of ``fields``.
    """
    dtype = as_dtype(np.asarray(d["fields"]).dtype if dtype is None
                     else dtype)
    return BasicState(
        **{k: _tensor(d[k], device, dtype)
           for k in ("fields", "lon", "lat", "betam", "ks", "q")},
        xcyclic=bool(np.asarray(d["xcyclic"])),
        bg_t0=float(np.asarray(d.get("bg_t0", 0.0))),
        bg_dt=float(np.asarray(d.get("bg_dt", 1.0))),
    )


def background_from_numpy(d: Mapping, *, device="cuda",
                          dtype=None) -> Background:
    """A port ``Background`` from a mapping shaped like the JAX one: a
    static (W, H, C), time-varying (T, W, H, C) or ensemble (M, W, H, C) or
    (M, T, W, H, C) stack, with the (R,) ``member_ids`` of an ensemble
    (int32) or without (absent or None)."""
    dtype = as_dtype(np.asarray(d["fields"]).dtype if dtype is None
                     else dtype)
    scalars = {k: as_scalar(np.asarray(d[k], np.float64), dtype)
               for k in ("lon0", "lat0", "dx", "dy", "freq", "bg_t0",
                         "bg_dt") if k in d}
    member = d.get("member_ids")
    if member is not None:
        member = torch.as_tensor(np.asarray(member, np.int32)).to(device)
    return Background(fields=_tensor(d["fields"], device, dtype).contiguous(),
                      member_ids=member, **scalars)


def trajectories_from_numpy(d: Mapping, *, device="cuda",
                            dtype=None) -> RayTrajectories:
    """A port ``RayTrajectories`` from a mapping shaped like the JAX one
    (lon, lat, kx, ky, amp, ug, vg, each (nt, 3, nsource, nzwn)); ``dtype``
    defaults to that of ``lon``."""
    dtype = as_dtype(np.asarray(d["lon"]).dtype if dtype is None else dtype)
    return RayTrajectories(**{k: _tensor(d[k], device, dtype)
                              for k in RayTrajectories._fields})


def flux_to_numpy(wrf) -> dict:
    """The fields of a ``WaveRayFlux`` (or any NamedTuple of tensors) as
    numpy arrays, by name."""
    return {k: host(v) for k, v in wrf._asdict().items()}
