"""Diagnostics over traced trajectories and backgrounds: the Li-Yang
wave-ray flux (``flux``; its file driver ``wrf_cli``), termination
accounting with exact death causes, the grid-wide wavenumber maps, the
SHSF filter (``spectral``) and differentiable source targeting
(``targeting.optimize_seeds``)."""

from rwrt_tpu_torch.diagnostics.flux import (RegionStatistics, WaveRayFlux,
                                             ensemble_flux_statistics,
                                             region_mask, region_statistics,
                                             threshold_filter, wave_ray_flux,
                                             wave_ray_flux_chunked)
from rwrt_tpu_torch.diagnostics.spectral import shsf, spectral_filter
from rwrt_tpu_torch.diagnostics.targeting import optimize_seeds
from rwrt_tpu_torch.diagnostics.termination import (TerminationReport,
                                                     analyze, classify,
                                                     death_steps)
from rwrt_tpu_torch.diagnostics.wavenumber import (
    WavenumberMaps, compute_wavenumber_maps, fill_nan_neighborhood_mean,
    postprocess_maps, turning_critical_masks)

__all__ = ["WaveRayFlux", "RegionStatistics", "region_mask",
           "region_statistics", "threshold_filter", "wave_ray_flux",
           "wave_ray_flux_chunked", "ensemble_flux_statistics",
           "shsf", "spectral_filter",
           "TerminationReport", "analyze", "classify", "death_steps",
           "WavenumberMaps", "compute_wavenumber_maps", "postprocess_maps",
           "fill_nan_neighborhood_mean", "turning_critical_masks",
           "optimize_seeds"]
