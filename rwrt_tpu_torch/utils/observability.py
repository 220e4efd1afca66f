"""Observability: the run banner, the chunked driver's progress bar, the
device profile and the spans inside it.

Port of ``rwrt_tpu/utils/observability.py``: ``run_banner`` and
``Progress`` (the reference's configuration banner and text progress bar),
host-side and unchanged, and ``profile``, which is ``torch.profiler`` here
where the JAX package has ``jax.profiler``; the step attempts come from the
integrators themselves (``stats["lane_att"]``). ``span`` and ``spanned``
name the stages of a call in that profile (``tracer.trace_rays``' spans).
"""

from __future__ import annotations

import contextlib
import functools
import os
import sys
import tempfile
import time

import torch

from rwrt_tpu_torch.config import RunConfig
from rwrt_tpu_torch.constants import day


def run_banner(config: RunConfig, nlon: int, nlat: int, *, file=sys.stdout):
    """Print the run-configuration banner (reference ray_info)."""
    w = file.write
    w("=" * 78 + "\n")
    w(" rwrt_tpu_torch: Barotropic Horizontal Rossby Wave Ray Tracing\n")
    w(f" Basic flow grid (nlon x nlat): {nlon} x {nlat}\n")
    w(f" Initial zonal wavenumbers ({config.nzwn}): "
      + " ".join(f"{z:.1f}" for z in config.zwn) + "\n")
    w(f" Sources: {config.nsource} points, SW corner "
      f"({config.sw_lon:.2f}E, {config.sw_lat:.2f}N), "
      f"d(lon,lat)=({config.dlon:.2f}, {config.dlat:.2f}) deg, "
      f"{config.nnx} x {config.nny}\n")
    w(f" Time step (s): {config.tstep:.1f}\n")
    w(f" Total integration time (day): {config.ttotal / day:.1f}\n")
    w(f" Total output steps (nt): {config.nt}\n")
    w(f" Integrator: {config.integrator}  dtype: {config.cal_dtype}\n")
    w("=" * 78 + "\n")
    file.flush()


class Progress:
    """Progress bar and ray-step-rate reporter."""

    def __init__(self, total: int, bar_length: int = 50, file=sys.stdout):
        self.total = total
        self.bar_length = bar_length
        self.file = file
        self.t0 = time.perf_counter()
        self.ray_steps = 0

    def update(self, current: int, ray_steps: int = 0, alive_frac=None):
        self.ray_steps += ray_steps
        frac = current / max(self.total, 1)
        n = int(round(frac * self.bar_length))
        arrow = "=" * max(n - 1, 0) + ">"
        spaces = " " * (self.bar_length - len(arrow))
        rate = self.ray_steps / max(time.perf_counter() - self.t0, 1e-9)
        extra = f" {rate:,.0f} ray-steps/s" if self.ray_steps else ""
        if alive_frac is not None:
            extra += f" alive {alive_frac:5.1%}"
        self.file.write(f"\rprogress: [{arrow}{spaces}] {frac:5.1%}{extra}")
        self.file.flush()
        if current >= self.total:
            self.file.write("\n")


@contextlib.contextmanager
def profile(logdir=None):
    """Profile the block with ``torch.profiler`` (host activity, and the
    card's where one is present) and write it as a Chrome trace,
    ``<logdir>/trace.json`` (view in chrome://tracing or Perfetto).
    ``logdir`` defaults to ``rwrt_tpu_torch_profile`` under the temporary
    directory. Yields the profiler, whose ``key_averages()`` give the time
    by operator and kernel."""
    logdir = logdir or os.path.join(tempfile.gettempdir(),
                                    "rwrt_tpu_torch_profile")
    os.makedirs(logdir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


#: What ``span`` returns while no profiler records.
_OFF = contextlib.nullcontext()


def span(name: str):
    """A context that marks its block as the stage ``name`` in the trace of
    a recording ``torch.profiler`` (``profile``, or any other): a host range
    on the trace's clock, nesting the operators called in it and, through
    them, the device work they launched (its ``device_time_total``).

    The range is recorded as an operator (``_RecordFunctionFast``), not as
    ``record_function``'s user annotation, which the profiler also lays on
    the device's timeline: a trace's device events stay the device's work.
    While no profiler records, one shared null context, after one check."""
    if not torch._C._autograd._profiler_enabled():
        return _OFF
    return torch._C._profiler._RecordFunctionFast(name)


def spanned(name: str):
    """Decorate a function to run inside ``span(name)``."""

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return call

    return wrap
