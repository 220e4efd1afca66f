"""Diagnostics over traced trajectories: termination accounting."""

from rwrt_tpu_torch.diagnostics.termination import (TerminationReport,
                                                     analyze, classify,
                                                     death_steps)

__all__ = ["TerminationReport", "analyze", "classify", "death_steps"]
