"""Diagnostics over traced trajectories and backgrounds: termination
accounting, the grid-wide wavenumber maps and the SHSF filter
(``spectral``)."""

from rwrt_tpu_torch.diagnostics.termination import (TerminationReport,
                                                     analyze, classify,
                                                     death_steps)
from rwrt_tpu_torch.diagnostics.wavenumber import (WavenumberMaps,
                                                    compute_wavenumber_maps,
                                                    postprocess_maps,
                                                    turning_critical_masks)

__all__ = ["TerminationReport", "analyze", "classify", "death_steps",
           "WavenumberMaps", "compute_wavenumber_maps", "postprocess_maps",
           "turning_critical_masks"]
