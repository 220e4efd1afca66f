"""The program's spans and host-sync counter as the harness reads them.

The program marks the stages of a request as host ranges
(``rwrt.*``, operator ranges the profiler lays on no device timeline):
in a trace they leave the device's busy time, its operations and every
accepted reader's value as they were, and an idle gap in which the host ran
the program's own Python inside a stage takes the stage's name.
``tracer.host_syncs`` reads the program's ``tracer.HOST_SYNCS`` a request,
and nothing from a program without it.
"""

import json
from pathlib import Path
from types import SimpleNamespace

import pytest

from portbench import run, spec, trace

ROOT = Path(__file__).resolve().parent.parent.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def _event(name, start, end, device=False):
    kind = SimpleNamespace(name="CUDA" if device else "CPU")
    return SimpleNamespace(name=name, device_type=kind,
                           time_range=SimpleNamespace(start=start, end=end))


def _window():
    """One traced request, 0-100 us: the launch 10-12, the RK4 kernel
    20-60 on the card, a read 65-70 (its copy 65-66); the card idles
    0-20, 60-65 and 66-100; the harness's spans with their copy on the
    device's timeline."""
    return [
        _event(trace.WINDOW, 0.0, 100.0),
        _event(trace.REQUEST, 0.0, 100.0),
        _event(trace.REQUEST, 0.0, 100.0, device=True),
        _event("cudaLaunchKernel", 10.0, 12.0),
        _event("rk4_kernel<double>", 20.0, 60.0, device=True),
        _event("aten::copy_", 65.0, 70.0),
        _event("Memcpy DtoH", 65.0, 66.0, device=True),
    ]


def _spans():
    """The program's spans over that request (host ranges only)."""
    return [
        _event("rwrt.trace_rays", 1.0, 99.0),
        _event("rwrt.inputs", 1.0, 8.0),
        _event("rwrt.run", 9.0, 62.0),
        _event("rwrt.expand", 72.0, 98.0),
    ]


def _context(summary):
    return run.Context(trace=summary, requests=summary.requests,
                       request_ms=0.1, launches={"rk4_kernel": 1},
                       dropped={}, peak_bytes=2 ** 30, facts=None,
                       bounds={})


def test_program_spans_leave_the_trace_and_readers_as_they_were():
    plain = trace.summarize(_window())
    spanned = trace.summarize(_window() + _spans())
    assert spanned.busy_us == plain.busy_us == 41.0
    assert spanned.ops == plain.ops
    assert spanned.window_us == plain.window_us
    assert spanned.requests == plain.requests == 1
    names = [m["name"] for m in BENCH["per_layer"]
             if m["name"] != "tracer.host_syncs"]
    for name in names:
        read = spec.reader(name)
        assert read(_context(spanned)) == read(_context(plain)), name
    # The gaps by the host's innermost range at their middle: 0-20 (10:
    # the launch), 60-65 (62.5: Python between stages) and 66-100 (83:
    # Python in rwrt.expand), the last two "host" without the spans.
    assert plain.gaps == {"cudaLaunchKernel": 20.0, "host": 39.0}
    assert spanned.gaps == {"cudaLaunchKernel": 20.0,
                            "rwrt.trace_rays": 5.0, "rwrt.expand": 34.0}


@pytest.fixture
def counters(monkeypatch):
    from rwrt_tpu_torch import tracer

    for name, value in (("HOST_SYNCS", 70), ("LAUNCHES", 0),
                        ("RK4_LAUNCHES", 10), ("EXACT_LAUNCHES", 0)):
        monkeypatch.setattr(tracer, name, value)
    return tracer


def test_host_syncs_a_request_by_hand(counters):
    read = spec.reader("tracer.host_syncs")
    ctx = _context(trace.summarize(_window()))
    ctx.requests = 3
    ctx.launches = {"dense_kernel": 0, "rk4_kernel": 3, "exact_kernel": 0,
                    "entry_kernel": 0}
    # 70 syncs over 10 launches, one launch a traced request.
    assert read(ctx) == 7.0
    ctx.launches["rk4_kernel"] = 6
    assert read(ctx) == 14.0


def test_host_syncs_read_nothing_without_the_counter(counters, monkeypatch):
    read = spec.reader("tracer.host_syncs")
    ctx = _context(trace.summarize(_window()))
    ctx.launches = {"dense_kernel": 0, "rk4_kernel": 1, "exact_kernel": 0,
                    "entry_kernel": 0}
    assert read(ctx) == 7.0
    monkeypatch.delattr(counters, "HOST_SYNCS")
    assert read(ctx) is None


def test_host_syncs_read_nothing_without_a_launch(counters, monkeypatch):
    read = spec.reader("tracer.host_syncs")
    ctx = _context(trace.summarize(_window()))
    ctx.launches = {"dense_kernel": 0, "rk4_kernel": 0, "exact_kernel": 0,
                    "entry_kernel": 0}
    assert read(ctx) is None
    monkeypatch.setattr(counters, "RK4_LAUNCHES", 0)
    ctx.launches["rk4_kernel"] = 1
    assert read(ctx) is None
