"""rwrt_tpu_torch: the PyTorch/CUDA port of rwrt_tpu.

Barotropic Rossby-wave ray tracing with plain PyTorch around hand-written
CUDA kernels for the RHS, the adaptive runs' entry stage (f0 and the
initial step), the whole RK4, exact-bound and dense Dormand-Prince runs
(and single groups of the latter two), the spectral sampler and the flux
binning (built from ``csrc/`` at first use on a CUDA device), and the
chunked checkpoint/resume driver over them (``utils/checkpoint.py``), over
static or time-varying backgrounds (``prepare_time_varying``) and ensembles
of them (``trace_rays_ensemble``), in canonical or the reference's
('fortran') root order, from computed or given (``initial_state``) seeds,
on one device or split over a mesh of them (``parallel.sharding``).
Above them the file-driven pipeline: wind ingest with regrid and SHSF,
the basic-state, trajectory and wavenumber-map files (``io/ncio.py``), the
run driver (``main.run``) and the CLI, ``python -m rwrt_tpu_torch --config
run.json``, with exact death causes in its report
(``diagnostics.termination.classify``, ``--report-exact``). Over the
trajectories, the Li-Yang wave-ray flux (``diagnostics.flux``, on the
hand-written flux-binning kernel) and its file driver, ``python -m
rwrt_tpu_torch.diagnostics.wrf_cli``; and the generic batched ODE solvers
(``solvers.ode``). The JAX package ``rwrt_tpu`` is the reference each
module is tested against; this package never imports it or JAX.
"""

__version__ = "0.1.0"

from rwrt_tpu_torch.config import RunConfig
from rwrt_tpu_torch.diagnostics.targeting import optimize_seeds
from rwrt_tpu_torch.models.basic_state import (BasicState, prepare,
                                               prepare_time_varying,
                                               regrid_to_uniform)
from rwrt_tpu_torch.tracer import (RayTrajectories, source_matrix, trace_rays,
                                   trace_rays_ensemble)
from rwrt_tpu_torch.utils.checkpoint import trace_rays_chunked

__all__ = [
    "RunConfig",
    "BasicState",
    "prepare",
    "prepare_time_varying",
    "regrid_to_uniform",
    "RayTrajectories",
    "source_matrix",
    "trace_rays",
    "trace_rays_ensemble",
    "trace_rays_chunked",
    "optimize_seeds",
]
