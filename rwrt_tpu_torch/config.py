"""Typed run configuration (port of ``rwrt_tpu/config.py``).

Same fields, same defaults and the same ``validate`` as the JAX package, so a
configuration written for one runs unchanged on the other. Which of its
branches the port's ``trace_rays`` serves is decided there, not here.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from rwrt_tpu_torch.constants import day, hour, mwn_cap


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Configuration for a ray-tracing run."""

    # Wave frequency in rad/s; 0 = stationary Rossby waves.
    freq: float = 0.0
    # Initial zonal wavenumbers (dimensionless k*R).
    zwn: Sequence[float] = (1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 7.0)
    # Source matrix: SW corner (degrees), spacing (degrees), counts.
    sw_lon: float = 70.0
    sw_lat: float = -4.0
    dlon: float = 4.0
    dlat: float = 2.0
    nnx: int = 21
    nny: int = 15
    # Time stepping.
    tstep: float = 2.0 * hour        # seconds
    ttotal: float = 90.0 * day       # seconds
    # Integrator: 'rk4' (fixed step) or 'rk45' (adaptive Dormand-Prince).
    integrator: str = "rk4"
    # Adaptive-solver controls.
    rtol: float = 1e-6
    atol: float = 1e-6
    min_step_factor: float = 1e-3
    # Output intervals advanced per integrator group.
    interval_batch: int = 16
    # 'exact' clamps every step at every output bound; 'dense' steps past
    # the bounds and emits them from the Dormand-Prince quartic interpolant.
    bound_mode: str = "exact"
    # Peel scheduling of the JAX chunked driver. The port's chunked driver
    # takes it and the difficulty buckets below at any value: each is
    # bitwise equal per lane to the plain chunk, which one kernel launch
    # runs here (utils/checkpoint.py).
    peel: bool = True
    peel_caps: Sequence[int] = (24, 96)
    peel_caps_exact: Optional[Sequence[int]] = None
    # Straggler pin-kill (dense mode): NaN-retire a lane once its per-group
    # step-attempt count reaches pin_limit while |l| >= pin_mwn. None = off.
    pin_limit: Optional[int] = None
    pin_mwn: float = 50.0
    # Difficulty-bucketed lane scheduling (see peel).
    difficulty_buckets: int = 1
    # Displacement kill threshold, radians per tstep-hour.
    cut_off: float = 0.1
    # Root-slot layout of the output arrays: 'canonical' or 'fortran'.
    root_order: str = "canonical"
    # Drop never-born (rootless) lanes from the integrated batch.
    compact_rootless: bool = True
    # Drop dead lanes at chunk boundaries of the chunked driver.
    compact_dead: bool = True
    # Background handling.
    xcyclic: bool = True
    bg_t0: float = 0.0
    bg_dt: float = 0.0
    # Spherical-harmonic smoothing of the input wind at ingest.
    shsf_truncation: Optional[int] = None
    shsf_mode: str = "projection"
    # Bilinear regrid of the input wind onto the uniform grid at ingest.
    regrid: bool = False
    # dtypes: read (ingest) and compute.
    read_dtype: str = "float32"
    cal_dtype: str = "float32"
    # Integrated-state dtype: 'compute' (= cal_dtype) or 'float64'.
    state_dtype: str = "compute"
    # Devices along the ray-sharding mesh axis; None = all local devices.
    mesh_devices: Optional[int] = None

    @property
    def nt(self) -> int:
        return int(self.ttotal / self.tstep) + 1

    @property
    def nsource(self) -> int:
        return self.nnx * self.nny

    @property
    def nzwn(self) -> int:
        return len(self.zwn)

    @property
    def cut_off_rad(self) -> float:
        return self.cut_off * self.tstep / 3600.0

    def zwn_array(self) -> np.ndarray:
        return np.asarray(self.zwn, dtype=self.cal_dtype)

    def validate(self) -> "RunConfig":
        if self.integrator not in ("rk4", "rk45"):
            raise ValueError(f"unknown integrator {self.integrator!r}")
        if self.root_order not in ("canonical", "fortran"):
            raise ValueError(f"unknown root_order {self.root_order!r}")
        if self.state_dtype not in ("compute", "float64"):
            raise ValueError(f"unknown state_dtype {self.state_dtype!r}")
        if self.nnx * self.nny < 1:
            raise ValueError("empty source matrix")
        lat_ends = (self.sw_lat, self.sw_lat + (self.nny - 1) * self.dlat)
        if max(lat_ends) > 89.0 or min(lat_ends) < -89.0:
            raise ValueError("source latitude out of -90~90 range!")
        if self.tstep <= 0 or self.ttotal <= 0:
            raise ValueError("tstep and ttotal must be positive")
        if len(self.zwn) == 0:
            raise ValueError("zwn must name at least one zonal wavenumber")
        if self.rtol <= 0 or self.atol <= 0:
            raise ValueError("rtol and atol must be positive")
        if self.interval_batch < 1:
            raise ValueError("interval_batch must be >= 1")
        if self.min_step_factor < 0 or self.cut_off < 0:
            raise ValueError("min_step_factor and cut_off must be >= 0")
        if self.difficulty_buckets < 1:
            raise ValueError("difficulty_buckets must be >= 1")
        for name in ("peel_caps", "peel_caps_exact"):
            caps = getattr(self, name)
            if caps is None:
                continue
            caps = tuple(int(c) for c in caps)
            if any(c < 1 for c in caps) or list(caps) != sorted(set(caps)):
                raise ValueError(
                    f"{name} must be strictly increasing positive ints, "
                    f"got {tuple(getattr(self, name))!r}")
        if self.bg_dt < 0:
            raise ValueError("bg_dt must be >= 0 (seconds between frames)")
        if self.shsf_truncation is not None and self.shsf_truncation < 1:
            raise ValueError("shsf_truncation must be >= 1 (or None)")
        if self.shsf_mode not in ("projection", "dh"):
            raise ValueError(f"unknown shsf_mode {self.shsf_mode!r}")
        if self.bound_mode not in ("exact", "dense"):
            raise ValueError(f"unknown bound_mode {self.bound_mode!r}")
        if self.bound_mode == "dense":
            if self.integrator != "rk45":
                raise ValueError(
                    "bound_mode='dense' requires integrator='rk45'")
            if self.interval_batch <= 1 or self.nt <= 2:
                raise ValueError(
                    "bound_mode='dense' runs on the grouped adaptive path, "
                    "which needs interval_batch > 1 and nt > 2 (got "
                    f"interval_batch={self.interval_batch}, nt={self.nt}); "
                    "use bound_mode='exact' for these settings")
        if self.pin_limit is not None:
            if self.bound_mode != "dense":
                raise ValueError(
                    "pin_limit is implemented for bound_mode='dense' only")
            if int(self.pin_limit) < 1:
                raise ValueError("pin_limit must be a positive int")
            if not (0 <= float(self.pin_mwn) <= mwn_cap):
                raise ValueError(
                    f"pin_mwn must be in [0, {mwn_cap}] (the reference's "
                    f"|m| kill cap; 0 = attempts-only gating), "
                    f"got {self.pin_mwn}")
        return self
