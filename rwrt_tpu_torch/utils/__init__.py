"""Utilities: observability (banner, progress) and the chunked
checkpoint/resume driver."""

from rwrt_tpu_torch.utils.checkpoint import (ChunkBudgetReached,
                                             trace_rays_chunked)
from rwrt_tpu_torch.utils.observability import Progress, run_banner

__all__ = ["ChunkBudgetReached", "trace_rays_chunked", "Progress",
           "run_banner"]
