"""Utilities: observability (banner, progress, profile) and the chunked
checkpoint/resume driver."""

from rwrt_tpu_torch.utils.checkpoint import (ChunkBudgetReached,
                                             trace_rays_chunked)
from rwrt_tpu_torch.utils.observability import Progress, profile, run_banner

__all__ = ["ChunkBudgetReached", "trace_rays_chunked", "Progress",
           "profile", "run_banner"]
