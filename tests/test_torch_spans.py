"""The spans inside ``trace_rays`` and ``trace_rays_ensemble``
(``utils.observability.span``) and the host-sync counter
(``tracer.HOST_SYNCS``).

On the CPU: under ``observability.profile()`` each call leaves its span
tree (one root, its stages in order below it, no other ``rwrt.`` range)
for rk4, dense rk45, exact rk45 and the ensemble, as operator ranges that
the profiler lays on no device timeline; with no profiler recording no
record function is entered; the rows are bitwise those of the call
without the profiler; a CPU state counts no host sync, an upload to a
device counts one. ``profile_spans.span_summary`` reduces a trace as
computed by hand. Marked ``cuda`` (skips without a card): every
synchronizing operation torch sees inside a request is one the counter
counts, and a request of the reference configuration counts 7. The file
needs neither JAX nor the conftest:

    python -m pytest --noconftest tests/test_torch_spans.py -q
"""

import json
import warnings
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import profile_spans
import rwrt_tpu_torch as pt
from rwrt_tpu_torch import tracer
from rwrt_tpu_torch.utils import observability

REPO = Path(__file__).resolve().parent.parent
DAY = 86400.0
GRID = dict(zwn=(2.0, 4.0, 6.0), sw_lon=0.0, sw_lat=5.0, dlon=36.0,
            dlat=8.0, nnx=5, nny=4, tstep=7200.0, ttotal=DAY / 2,
            cal_dtype="float64")
CASES = {
    "rk4": dict(integrator="rk4"),
    "dense": dict(integrator="rk45", bound_mode="dense", interval_batch=8,
                  pin_limit=500, pin_mwn=0.0),
    "exact": dict(integrator="rk45", bound_mode="exact", interval_batch=8),
}
STAGES = ["rwrt.inputs", "rwrt.seed", "rwrt.compact", "rwrt.run"]


@pytest.fixture(scope="module")
def jet_field():
    """The conftest's synthetic jet, repeated so the file runs without it."""
    nlon, nlat = 72, 37
    lat = np.linspace(-np.pi / 2, np.pi / 2, nlat)
    lon = np.arange(nlon) * 2 * np.pi / nlon
    u = (
        20.0 * np.cos(lat)[None, :] ** 2
        + 8.0 * np.cos(2 * lon)[:, None] * np.cos(lat)[None, :] ** 2
        + 25.0 * np.exp(-(((np.degrees(lat)[None, :] - 40.0) / 12.0) ** 2))
    )
    v = 3.0 * np.sin(lon)[:, None] * np.cos(lat)[None, :]
    return u, v, lat, lon


@pytest.fixture(scope="module")
def states(jet_field):
    u, v, lat, lon = jet_field
    return [pt.prepare(u * s, v, lat, lon, cal_dtype=torch.float64,
                       device="cpu") for s in (1.0, 0.9)]


def call(states, case):
    """The call of ``case``: a ``trace_rays`` branch, or the two-member
    ensemble (rk4)."""
    if case == "ensemble":
        return pt.trace_rays_ensemble(states, pt.RunConfig(**GRID))
    return [pt.trace_rays(states[0], pt.RunConfig(**GRID, **CASES[case]))]


def expected(case):
    root = ("rwrt.trace_rays_ensemble" if case == "ensemble"
            else "rwrt.trace_rays")
    adaptive = case in ("dense", "exact")
    return root, STAGES + ["rwrt.truncation"] * adaptive + ["rwrt.expand"]


def same(a, b):
    return torch.equal(torch.isnan(a), torch.isnan(b)) and torch.equal(
        torch.nan_to_num(a), torch.nan_to_num(b))


def nearest_span(event):
    up = event.cpu_parent
    while up is not None and not up.name.startswith("rwrt."):
        up = up.cpu_parent
    return up


@pytest.mark.parametrize("case", list(CASES) + ["ensemble"])
def test_profiled_call_leaves_its_span_tree(states, case, tmp_path):
    with observability.profile(tmp_path) as prof:
        trajs = call(states, case)
    spans = sorted((e for e in prof.events()
                    if e.name.startswith("rwrt.")),
                   key=lambda e: (e.time_range.start, -e.time_range.end))
    root, stages = expected(case)
    assert [e.name for e in spans] == [root] + stages
    assert nearest_span(spans[0]) is None
    for e in spans[1:]:
        assert nearest_span(e) is spans[0], e.name
        assert spans[0].time_range.start <= e.time_range.start
        assert e.time_range.end <= spans[0].time_range.end
    for a, b in zip(spans[1:], spans[2:]):
        assert a.time_range.end <= b.time_range.start
    # Operator ranges, not user annotations: the profiler lays no copy of
    # them on the device's timeline.
    assert not any(getattr(e, "is_user_annotation", False) for e in spans)
    trace = json.loads((tmp_path / "trace.json").read_text())
    cats = {e.get("cat") for e in trace["traceEvents"]
            if e.get("name", "").startswith("rwrt.")}
    assert cats == {"cpu_op"}
    assert len(trajs) == (2 if case == "ensemble" else 1)


@pytest.mark.parametrize("case", ["rk4", "dense", "ensemble"])
def test_rows_are_bitwise_with_and_without_the_profiler(states, case,
                                                        tmp_path):
    plain = call(states, case)
    with observability.profile(tmp_path):
        traced = call(states, case)
    for p, t in zip(plain, traced):
        for name in p._fields:
            assert same(getattr(p, name), getattr(t, name)), name


def test_no_record_function_without_a_profiler(states, monkeypatch,
                                               tmp_path):
    entered = []
    fast = torch._C._profiler._RecordFunctionFast

    class Counting:
        def __init__(self, name, *a, **kw):
            self.name, self.inner = name, fast(name, *a, **kw)

        def __enter__(self):
            entered.append(self.name)
            return self.inner.__enter__()

        def __exit__(self, *exc):
            return self.inner.__exit__(*exc)

    user = torch.autograd.profiler.record_function.__enter__

    def counting_user(self):
        entered.append(self.name)
        return user(self)

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", Counting)
    monkeypatch.setattr(torch.autograd.profiler.record_function,
                        "__enter__", counting_user)
    call(states, "dense")
    call(states, "ensemble")
    assert entered == []
    with observability.profile(tmp_path):
        call(states, "rk4")
    root, stages = expected("rk4")
    assert entered == [root] + stages


@pytest.mark.parametrize("kw", [dict(integrator="rk4"),
                                CASES["dense"],
                                dict(integrator="rk4", root_order="fortran"),
                                dict(integrator="rk4", state_dtype="float64")])
def test_a_cpu_state_counts_no_host_sync(states, kw):
    before = tracer.HOST_SYNCS
    cfg = pt.RunConfig(**GRID, **kw)
    pt.trace_rays(states[0], cfg)
    seeds = tracer.initialize(
        tracer.make_background(states[0], cfg.freq),
        *(torch.as_tensor(x) for x in tracer.source_matrix(
            cfg.sw_lon, cfg.sw_lat, cfg.dlon, cfg.dlat, cfg.nnx, cfg.nny)),
        torch.as_tensor(cfg.zwn_array()))[0]
    pt.trace_rays(states[0], cfg, initial_state=seeds.numpy())
    pt.trace_rays_ensemble(states, cfg)
    assert tracer.HOST_SYNCS == before


def test_an_upload_to_a_device_counts_one():
    before = tracer.HOST_SYNCS
    meta = tracer._upload(np.zeros(3), torch.device("meta"), torch.float32)
    assert meta.device.type == "meta" and meta.dtype == torch.float32
    assert tracer.HOST_SYNCS == before + 1
    tracer._upload(torch.zeros(3, device="meta"), torch.device("meta"))
    tracer._read(tracer._upload(np.zeros(3), torch.device("cpu")))
    assert tracer.HOST_SYNCS == before + 1


def _event(name, start, end, parent=None, device=False, device_us=0.0,
           thread=1):
    kind = SimpleNamespace(name="CUDA" if device else "CPU")
    return SimpleNamespace(
        name=name, cpu_parent=parent, device_type=kind, thread=thread,
        device_time_total=device_us,
        time_range=SimpleNamespace(start=start, end=end,
                                   elapsed_us=lambda: end - start))


def test_span_summary_reduces_a_trace_as_by_hand():
    # One request: the root 0-100 us, its stages 0-40 and 45-95 (a second
    # request's root alone, 200-220); the launches at 10 and 50, a copy at
    # 60; the device busy 20-30 and 50-90, and its copies of the program's
    # and the harness's ranges, which are no work.
    root = _event("rwrt.trace_rays", 0.0, 100.0)
    seed = _event("rwrt.seed", 0.0, 40.0, root, device_us=10.0)
    run = _event("rwrt.run", 45.0, 95.0, root, device_us=40.0)
    op = _event("aten::mul", 5.0, 15.0, seed)
    other = _event("rwrt.trace_rays", 200.0, 220.0)
    events = [
        root, seed, run, op, other,
        _event("cudaLaunchKernel", 10.0, 12.0, op),
        _event("cudaLaunchKernel", 50.0, 52.0, run),
        _event("cudaMemcpyAsync", 60.0, 61.0, run),
        _event("cudaLaunchKernel", 70.0, 71.0, run, thread=2),
        _event("kernel_a", 20.0, 30.0, device=True),
        _event("kernel_b", 50.0, 90.0, device=True),
        _event("rwrt.run", 50.0, 90.0, device=True),
        _event("portbench.request", 0.0, 230.0, device=True),
    ]
    out = profile_spans.span_summary(events)
    assert out["requests"] == 2
    assert out["spans"]["rwrt.seed"] == {"calls": 1, "wall_us": 40.0,
                                         "device_us": 10.0, "runtime": 1}
    assert out["spans"]["rwrt.run"] == {"calls": 1, "wall_us": 50.0,
                                        "device_us": 40.0, "runtime": 2}
    assert out["spans"]["rwrt.trace_rays"]["calls"] == 2
    assert out["spans"]["rwrt.trace_rays"]["runtime"] == 3
    assert out["root_us"] == 120.0 and out["children_us"] == 90.0
    assert out["idle_in_roots_us"] == (100.0 - 50.0) + 20.0
    assert out["window_idle_us"] == 220.0 - 50.0
    assert out["device_copies"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("case, count", [("rk4", 7), ("dense", 8),
                                         ("exact", 8), ("ensemble", 9)])
def test_the_counter_counts_every_sync_of_a_request(jet_field, case, count):
    """The reference configuration's zwn, sources and dtypes (rk4; the
    adaptive branches and a two-member ensemble beside it) over two days.
    A ``trace_rays`` request waits for the card 7 times: the sources' and
    zwn's uploads, ``make_background``'s reads of lon[0] and lat[0], the
    compaction's read of the born lanes and its index upload; an adaptive
    one reads its truncation count besides; the ensemble reads each
    member's lon[0] and lat[0]."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on a GPU machine)")
    u, v, lat, lon = jet_field
    ref = json.loads((REPO / "portbench" / "configs"
                      / "rk4_f64_reference.json").read_text())["run"]
    kw = {**ref, "zwn": tuple(ref["zwn"]), "ttotal": 2 * DAY}
    if case in CASES:
        kw.update(CASES[case])
    cfg = pt.RunConfig(**kw)
    states = [pt.prepare(u * s, v, lat, lon, read_dtype=torch.float32,
                         cal_dtype=torch.float64, device="cuda")
              for s in (1.0, 0.9)]

    def request():
        if case == "ensemble":
            return pt.trace_rays_ensemble(states, cfg)
        return pt.trace_rays(states[0], cfg)

    def watched():
        """The synchronizing operations torch warns of in a request."""
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                request()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        return sum("synchroniz" in str(w.message) for w in seen)

    # The first watched request of a process also sees one sync of torch's
    # own, outside the program (at the parent too).
    watched()
    before = tracer.HOST_SYNCS
    syncs = watched()
    assert tracer.HOST_SYNCS - before == syncs == count
