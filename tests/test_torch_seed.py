"""The seed stage's routes (``tracer.initialize``) on the CPU.

On the card ``initialize`` is one launch of ``csrc/seed.cu`` where
``tracer._seed_kernel_takes`` it (tests/test_torch_cuda_kernels.py holds
the kernel bitwise to the plain route there); every other call runs the
plain composition. Here: every call counts in ``SEED_CALLS`` and none
launches; the rule refuses a gradient-carrying input and root_order
'fortran'; the launch refuses inputs of another dtype or device than the
background's before it touches the card; an ensemble's stack seeds each member as the member's own background does;
the targeting gradient through the seeds is the plain composition's. The
file needs neither JAX nor the conftest:

    python -m pytest --noconftest tests/test_torch_seed.py -q
"""

import numpy as np
import pytest
import torch

import rwrt_tpu_torch as pt
from rwrt_tpu_torch import tracer
from rwrt_tpu_torch.diagnostics import targeting

DAY = 86400.0
GRID = dict(zwn=(0.0, 2.0, 4.0, 6.0), sw_lon=0.0, sw_lat=5.0, dlon=36.0,
            dlat=8.0, nnx=5, nny=4, tstep=7200.0, ttotal=DAY / 4,
            cal_dtype="float64")


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


def same(a, b):
    return torch.equal(torch.isnan(a), torch.isnan(b)) and torch.equal(
        torch.nan_to_num(a), torch.nan_to_num(b))


def seed_inputs(bs, cfg, dtype=torch.float64):
    bg = tracer.make_background(bs, cfg.freq)
    slon, slat = tracer.source_matrix(cfg.sw_lon, cfg.sw_lat, cfg.dlon,
                                      cfg.dlat, cfg.nnx, cfg.nny)
    return bg, tuple(torch.as_tensor(x, dtype=dtype)
                     for x in (slon, slat, cfg.zwn_array()))


def counters():
    return tracer.SEED_CALLS, tracer.SEED_LAUNCHES


@pytest.mark.parametrize("case", ["trace_rays", "fortran", "ensemble",
                                  "gradient", "initial_state"])
def test_every_cpu_call_counts_and_launches_nothing(states, case):
    cfg = pt.RunConfig(**GRID, root_order=("fortran" if case == "fortran"
                                           else "canonical"))
    before = counters()
    if case == "ensemble":
        pt.trace_rays_ensemble(states, cfg)
    elif case == "gradient":
        bg, (slon, slat, zwn) = seed_inputs(states[0], cfg)
        slat.requires_grad_(True)
        y0, _, _ = tracer.initialize(bg, slon, slat, zwn)
        (g,) = torch.autograd.grad(y0[1].sum(), slat)
        assert torch.equal(g, torch.full_like(g, 3.0 * len(cfg.zwn)))
    elif case == "initial_state":
        bg, inputs = seed_inputs(states[0], cfg)
        seeds = tracer.initialize(bg, *inputs)[0]
        pt.trace_rays(states[0], cfg, initial_state=seeds.numpy())
    else:
        pt.trace_rays(states[0], cfg)
    # One call a request (the ensemble's members in one), two with a given
    # initial state (its own initialize, then the seeds it discards).
    calls = 2 if case == "initial_state" else 1
    assert counters() == (before[0] + calls, before[1])


@pytest.mark.parametrize("case, takes", [
    ("canonical", True), ("fortran", False), ("source_grad", False),
    ("fields_grad", False), ("grad_under_no_grad", True)])
def test_the_kernel_rule(states, case, takes):
    """``_seed_kernel_takes``, the rule the card's calls take: everything
    but the device, which ``initialize`` tests first."""
    cfg = pt.RunConfig(**GRID)
    bg, inputs = seed_inputs(states[0], cfg)
    if case == "source_grad":
        inputs[0].requires_grad_(True)
    if case in ("fields_grad", "grad_under_no_grad"):
        bg = bg._replace(fields=bg.fields.clone().requires_grad_(True))
    order = "fortran" if case == "fortran" else "canonical"
    with torch.set_grad_enabled(case != "grad_under_no_grad"):
        assert tracer._seed_kernel_takes(bg, inputs, order) is takes


@pytest.mark.parametrize("case", ["float32_sources", "float32_zwn",
                                  "meta_sources", "matrix_zwn"])
def test_the_launch_refuses_mismatched_inputs(states, case):
    """The kernel's wrapper raises ValueError, and launches nothing, for
    sources or zwn of another dtype, device or shape than the background's
    vectors: the card takes no quiet plain route and no promotion for
    them. The checks come before any CUDA call, so they run here."""
    cfg = pt.RunConfig(**GRID)
    bg, (slon, slat, zwn) = seed_inputs(states[0], cfg)
    if case == "float32_sources":
        slon, slat = slon.float(), slat.float()
    elif case == "float32_zwn":
        zwn = zwn.float()
    elif case == "meta_sources":
        slon = slon.to("meta")
    else:
        zwn = zwn[None, :]
    before = counters()
    with pytest.raises(ValueError):
        tracer._initialize_cuda(bg, slon, slat, zwn)
    assert counters() == before


@pytest.mark.parametrize("timed", [False, True])
def test_an_ensemble_stack_seeds_each_member_as_its_own(jet_field, timed):
    """``initialize`` over a member-major ensemble stack (as
    ``trace_rays_ensemble`` lays it: static members, or members of 5
    frames from t = -0.3 days) is one call, each member's lanes bitwise its
    own background's seeds."""
    u, v, lat, lon = jet_field
    cfg = pt.RunConfig(**GRID)
    if timed:
        bss = [pt.prepare_time_varying(
            np.stack([s * (1.0 + 0.1 * k) * u for k in range(5)]),
            np.stack([np.roll(v, k, axis=0) for k in range(5)]), lat, lon,
            bg_t0=-0.3 * DAY, bg_dt=0.2 * DAY, cal_dtype=torch.float64,
            device="cpu")
            for s in (1.0, 0.9, 1.1)]
    else:
        bss = [pt.prepare(s * u, v, lat, lon, cal_dtype=torch.float64,
                          device="cpu")
               for s in (1.0, 0.9, 1.1)]
    bg, inputs = seed_inputs(bss[0], cfg)
    own = [tracer.initialize(seed_inputs(bs, cfg)[0], *inputs)
           for bs in bss]
    r = 3 * inputs[0].shape[0] * inputs[2].shape[0]
    ens = bg._replace(
        fields=torch.stack([seed_inputs(bs, cfg)[0].fields for bs in bss]),
        member_ids=torch.arange(3, dtype=torch.int32).repeat_interleave(r))
    before = counters()
    got = tracer.initialize(ens, *inputs)
    assert counters() == (before[0] + 1, before[1])
    for k, want in enumerate(zip(*own)):
        assert same(got[k], torch.cat(want, dim=-1)), k


def test_targeting_gradient_is_the_plain_compositions(states, monkeypatch):
    """The targeting objective's gradient in the seeds through
    ``initialize`` (a call that counts, and launches nothing) is the one
    through the plain composition itself, bitwise."""
    bg = tracer.make_background(states[0], 0.0)
    slon = torch.tensor([0.9, 2.4], dtype=torch.float64)
    lat0 = torch.tensor([0.6, 0.7], dtype=torch.float64)

    def grad():
        slat = lat0.clone().requires_grad_(True)
        d = targeting.miss_distance(bg, slon, slat, [2.0, 4.0], 2.5, 0.9,
                                    nt=8, dt=7200.0, cut_off=0.2)
        return torch.autograd.grad(d.sum(), slat)[0]

    before = counters()
    g = grad()
    assert counters() == (before[0] + 1, before[1])
    assert torch.isfinite(g).all() and bool((g != 0).any())
    monkeypatch.setattr(tracer, "initialize",
                        lambda bg_, *a: tracer._initialize_plain(bg_, *a))
    assert torch.equal(grad(), g)
