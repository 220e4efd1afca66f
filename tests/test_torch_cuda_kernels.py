"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``; each test skips when no CUDA device is present (decided in
a fixture, never at import). The file needs neither JAX nor the conftest,
so on a GPU machine without JAX run it as

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py -q

The library is built with -fmad=false, so the RHS kernel, both dense
kernels (one group, and the whole run with the kill cascade and (ug, vg)),
the RK4 kernel and both exact kernels (one group with its suspend/resume
state, and the whole run, with and without the barrier flag), each RK4 and
exact kernel in every instance (``kernels.INSTANCES``), and the whole-run
kernels' mixed-precision instances (a float64 state over a float32
background), must equal their plain versions bitwise; the
spectral kernel sums its
contraction on the tensor cores in another order than the matmul, so it is
held to 1e-12 (float64 coefficients, with or without rounded operands) and
1e-5 (float32 by 3xTF32, and bf16, float16 or float8 operands over
float32) of each channel's max |value|, to the plain version's non-finite
positions, and to bitwise equality between two of its own launches; its
operand rounding is bitwise the plain ``round_operands``. The
single-group kernels' time instances (over time-varying backgrounds and
ensembles, in float32, float64 and mixed) are bitwise too. The flux
kernel's count map, region mask and unwrap carry are bitwise (over time
blocks chained through the carry); its other maps are sums whose
atomics add in an order that changes from run to run, held to FLUX_BARS.
The interval kernel (``rk45.integrate_interval_rays``: each lane's RK45
loop to its own bound in one launch) is bitwise the plain loop in every
instance, static and time-varying, at caps that bind and that do not;
``termination.classify``'s re-run on the card goes through it (RK45) or
the RHS kernel (RK4) and labels every lane as the plain RHS does. The
entry-stage kernel (``tracer.entry_stage``: f0 and the initial step in
one launch) is bitwise its plain route in every instance, and every
adaptive path makes one entry launch and no RHS launch. The gather
kernel is a copy: bitwise. Gradients take the plain route on the
card (the roots' implicit-function backward equal to the CPU's, a
gradient through prepare -> RK4 equal to the CPU's to 1e-9), and every
kernel launch refuses a gradient-carrying input.
"""

import numpy as np
import pytest
import torch

import rwrt_tpu_torch as pt
from rwrt_tpu_torch import kernels, tracer
from rwrt_tpu_torch.models import ray
from rwrt_tpu_torch.ops import spectral_sample as spec
from rwrt_tpu_torch.solvers import rk4, rk45

pytestmark = pytest.mark.cuda

DTYPES = [torch.float32, torch.float64]


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


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on a GPU machine)")
    return torch.device("cuda", 0)


def same(a, b):
    return torch.equal(torch.isnan(a), torch.isnan(b)) and torch.equal(
        torch.nan_to_num(a), torch.nan_to_num(b))


def background(jet_field, dtype, dev):
    u, v, lat, lon = jet_field
    bs = pt.prepare(u, v, lat, lon, cal_dtype=dtype, device=dev)
    return bs, tracer.make_background(bs, 0.0)


def seeded_states(dtype, dev, n=5000):
    rng = np.random.default_rng(11)
    y = np.stack([rng.uniform(-1.0, 7.3, n), rng.uniform(-1.65, 1.65, n),
                  rng.uniform(1.0, 7.0, n), rng.normal(0.0, 30.0, n),
                  rng.uniform(0.5, 2.0, n)])
    for row in (0, 3, 4):
        y[row, rng.choice(n, 50, replace=False)] = np.nan
    return torch.as_tensor(y, dtype=dtype, device=dev).contiguous()


@pytest.mark.parametrize("gv", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_rhs_kernel_equals_plain(jet_field, dev, dtype, gv):
    _, bg = background(jet_field, dtype, dev)
    y = seeded_states(dtype, dev)
    before = ray.LAUNCHES
    k = ray._rhs(bg, y, 0.0, gv)
    p = ray._rhs_core(bg, y, 0.0, gv)
    assert ray.LAUNCHES == before + 1
    assert torch.equal(k[1], p[1])
    for a, b in zip(k[:1] + k[2:], p[:1] + p[2:]):
        if a is not None:
            assert same(a, b)


@pytest.mark.parametrize("pin", [None, (40, 0.0)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_dense_group_kernel_equals_plain(jet_field, dev, dtype, pin):
    _, bg = background(jet_field, dtype, dev)
    slon, slat = tracer.source_matrix(0.0, -40.0, 10.0, 5.0, 36, 17)
    y0, _, _ = tracer.initialize(
        bg, torch.as_tensor(slon, dtype=dtype, device=dev),
        torch.as_tensor(slat, dtype=dtype, device=dev),
        torch.arange(1, 8, dtype=dtype, device=dev))
    y0 = y0.contiguous()
    rtol = rk45.validate_tol(1e-6, dtype)
    h0 = tracer.initial_step_sizes(bg, y0, rtol, 1e-6)
    t0 = torch.zeros_like(y0[0])
    f0 = ray.RayRHS(bg)(y0)
    bounds = torch.arange(1, 25, dtype=dtype, device=dev) * 7200.0
    pin_kw = {} if pin is None else dict(pin_limit=pin[0], pin_mwn=pin[1])
    before = rk45.LAUNCHES
    k = rk45.integrate_group_dense(ray.RayRHS(bg), y0, t0, h0, f0, bounds,
                                   rtol, 1e-6, 7.2, **pin_kw)
    assert rk45.LAUNCHES == before + 1
    plain_rhs = lambda yy, tt=0.0: ray._rhs_core(bg, yy, tt, False)[0]  # noqa: E731
    p = rk45._integrate_group_dense_plain(
        plain_rhs, y0, t0, h0, f0, bounds, rtol, 1e-6, 7.2, 1_000_000,
        **pin_kw)
    for i in (0, 1, 2, 3, 4):
        assert same(k[i], p[i]), i
    for i in (7, 8, 9):
        assert torch.equal(k[i], p[i]), i
    assert int(k[5]) == p[5]


def dense_run_inputs(bg, dtype, dev, group=5, nt=13, state=None):
    """The entry state of a run over a 5 x 4 source grid plus three polar
    sources, zwn 2, 4, 6 (207 lanes, 72 rootless), and its padded bounds.
    ``state`` (float64 over a float32 ``bg``: mixed precision) widens y0,
    and h0, rtol and the bounds follow it; f0, ug0 and vg0 keep
    ``dtype``."""
    slon, slat = tracer.source_matrix(0.0, 5.0, 36.0, 8.0, 5, 4)
    slon = np.concatenate([slon, np.radians([10.0, 100.0, 200.0])])
    slat = np.concatenate([slat, np.radians([86.0, 88.5, -87.0])])
    y0, ug0, vg0 = tracer.initialize(
        bg, torch.as_tensor(slon, dtype=dtype, device=dev),
        torch.as_tensor(slat, dtype=dtype, device=dev),
        torch.tensor([2.0, 4.0, 6.0], dtype=dtype, device=dev))
    state = state or dtype
    y0 = y0.to(state).contiguous()
    rtol = rk45.validate_tol(1e-6, state)
    h0 = tracer.initial_step_sizes(bg, y0, rtol, 1e-6)
    f0 = ray.RayRHS(bg)(y0)
    bounds_g = tracer.padded_bounds(7200.0, nt, group, state, dev)
    return (y0, ug0.contiguous(), vg0.contiguous(), h0, f0, bounds_g,
            nt - 1), rtol


DENSE_RUN_CASES = {
    "pin": dict(cut_off=0.2, pin_limit=500, pin_mwn=0.0),
    "nopin": dict(cut_off=0.2),
    "cutoff": dict(cut_off=0.03, pin_limit=500, pin_mwn=0.0),
    "maxiters": dict(cut_off=0.2, pin_limit=500, pin_mwn=0.0, max_iters=3),
    "pin8": dict(cut_off=0.2, pin_limit=8, pin_mwn=0.0),
}


@pytest.mark.parametrize("case", list(DENSE_RUN_CASES))
@pytest.mark.parametrize("dtype", DTYPES)
def test_dense_run_kernel_equals_plain(jet_field, dev, dtype, case):
    """One launch; rows, ug, vg, per-group attempts, truncation counts and
    the carry bitwise equal to the plain run, NaN masks included."""
    _, bg = background(jet_field, dtype, dev)
    (y0, ug0, vg0, h0, f0, bounds_g, n_bounds), rtol = dense_run_inputs(
        bg, dtype, dev)
    kw = dict(DENSE_RUN_CASES[case])
    cut_off = kw.pop("cut_off")
    args = (bg, y0, ug0, vg0, h0, f0, bounds_g, n_bounds, cut_off, rtol,
            1e-6, 7.2)
    before = tracer.LAUNCHES, rk45.LAUNCHES, ray.LAUNCHES
    k = tracer._dense_run(*args, **kw)
    assert (tracer.LAUNCHES, rk45.LAUNCHES, ray.LAUNCHES) == (
        before[0] + 1, before[1], before[2])
    p = tracer._dense_run_plain(*args, **kw)
    assert k.ys.shape == (n_bounds + 1, 5, y0.shape[1])
    for a, b in zip(k[:3] + k.carry, p[:3] + p.carry):
        assert same(a, b)
    assert torch.equal(k.lane_att, p.lane_att)
    assert torch.equal(k.trunc, p.trunc)
    if case == "maxiters":
        assert int(k.trunc.sum()) > 0
    if case == "cutoff":
        # Born lanes (finite ky) killed by the cascade.
        assert (torch.isnan(k.ys[-1, 0]) & ~torch.isnan(y0[3])).any()


def test_dense_run_wrapper_refuses_bad_inputs(jet_field, dev):
    _, bg = background(jet_field, torch.float32, dev)
    (y0, ug0, vg0, h0, f0, bounds_g, n_bounds), rtol = dense_run_inputs(
        bg, torch.float32, dev)
    good = [bg, y0, ug0, vg0, h0, f0, bounds_g, n_bounds, 0.2, rtol, 1e-6,
            7.2]
    for pos, bad in ((1, y0.double()), (1, y0.T.contiguous().T),
                     (4, h0[:-1]), (6, bounds_g.reshape(-1)),
                     (7, bounds_g.numel() + 1)):
        args = list(good)
        args[pos] = bad
        with pytest.raises(ValueError):
            tracer._dense_run(*args)


def amp_nan(y0):
    """y0 with the amp of two born lanes NaN (exact mode walks them)."""
    y0 = y0.clone()
    born = torch.nonzero(torch.isfinite(y0[3])).flatten()
    y0[4, born[[0, 5]]] = float("nan")
    return y0


@pytest.mark.parametrize("dtype", DTYPES)
def test_rk4_kernel_equals_plain(jet_field, dev, dtype):
    """The whole run (row 0 from the kernel), and a chunk written at row
    offset 4 of a larger output from a carry: rows, (ug, vg) and carry
    bitwise equal to the plain loop."""
    _, bg = background(jet_field, dtype, dev)
    (y0, ug0, vg0, *_), _ = dense_run_inputs(bg, dtype, dev)
    before = tracer.RK4_LAUNCHES, ray.LAUNCHES
    k = tracer._run_rk4(bg, y0, ug0, vg0, 7200.0, 25, 0.03)
    assert (tracer.RK4_LAUNCHES, ray.LAUNCHES) == (before[0] + 1, before[1])
    p = tracer._run_rk4_plain(bg, y0, ug0, vg0, 7200.0, 25, 0.03)
    for a, b in zip(k, p):
        assert same(a, b)
    assert torch.isnan(k[0][-1, 0]).any() and torch.isfinite(k[0][-1, 0]).any()
    carry = k[0][10].contiguous()
    outs = [torch.full((12,) + tuple(x.shape[1:]), 7.0, dtype=dtype,
                       device=dev) for x in k]
    y_k = tracer._rk4_launch(bg, carry, 7200.0, 6, 0.03, *outs, 4)
    ref = [x.clone() for x in outs]
    for x in ref:
        x[4:10] = float("nan")
    y_p = rk4.trace_into(bg, carry, 7200.0, 6, 0.03, *ref, 4)
    for a, b in zip(outs, ref):
        assert same(a, b)
    assert same(y_k, y_p)
    assert same(outs[0][4:10], k[0][11:17])


@pytest.mark.parametrize("resume", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_exact_group_kernel_equals_plain(jet_field, dev, dtype, resume):
    """One 10-bound group, NaN-amp lanes included; with resume, both
    versions stop after 7 trips and resume from their own state."""
    _, bg = background(jet_field, dtype, dev)
    (y0, _, _, h0, f0, _, _), rtol = dense_run_inputs(bg, dtype, dev)
    y0 = amp_nan(y0)
    f0 = ray.RayRHS(bg)(y0)
    bounds = torch.arange(1, 11, dtype=dtype, device=dev) * 7200.0
    carry = (y0, torch.zeros_like(h0), h0, f0, y0[0].clone(), y0[1].clone())

    def plain_rhs(yy, tt=0.0):
        return ray._rhs_core(bg, yy, tt, False)[0]

    def plain_gv(yy, tt=0.0):
        dy, _, ug, vg = ray._rhs_core(bg, yy, tt, True)
        return dy, ug, vg

    def run(kernel, carry, max_iters, state0=None):
        if kernel:
            return rk45.integrate_group(
                ray.RayRHS(bg), None, *carry[:4], bounds, *carry[4:], 0.03,
                rtol, 1e-6, 7.2, max_iters, state0)
        return rk45._integrate_group_plain(
            plain_rhs, plain_gv, *carry[:4], bounds, *carry[4:], 0.03, rtol,
            1e-6, 7.2, max_iters, state0)

    before = rk45.EXACT_LAUNCHES
    k = run(True, carry, 7 if resume else 1_000_000)
    assert rk45.EXACT_LAUNCHES == before + 1
    p = run(False, carry, 7 if resume else 1_000_000)
    if resume:
        tails = [[x[i] for i in (0, 10, 11, 9, 12)] for x in (k, p)]
        k = run(True, k[1:7], 1_000_000, tails[0])
        p = run(False, p[1:7], 1_000_000, tails[1])
    for i in range(7):
        assert same(k[i], p[i]), i
    assert int(k[7]) == p[7]
    for i in (9, 10, 11, 12):
        assert torch.equal(k[i], p[i]), i


EXACT_RUN_CASES = {
    "default": dict(cut_off=0.2),
    "cutoff": dict(cut_off=0.03),
    "maxiters": dict(cut_off=0.2, max_iters=3),
    "one_bound": dict(cut_off=0.2, max_iters=100_000, group=1),
    "row0": dict(cut_off=0.2, group=1, nt=1),
}


@pytest.mark.parametrize("case", list(EXACT_RUN_CASES))
@pytest.mark.parametrize("dtype", DTYPES)
def test_exact_run_kernel_equals_plain(jet_field, dev, dtype, case):
    """One launch; rows, ug, vg, per-group attempts, truncation counts and
    the carry bitwise equal to the plain run, NaN-amp lanes included."""
    _, bg = background(jet_field, dtype, dev)
    kw = dict(EXACT_RUN_CASES[case])
    group, nt = kw.pop("group", 5), kw.pop("nt", 13)
    (y0, ug0, vg0, h0, _, _, _), rtol = dense_run_inputs(bg, dtype, dev)
    y0 = amp_nan(y0)
    f0 = ray.RayRHS(bg)(y0)
    bounds_g = tracer.padded_bounds(7200.0, nt, group, dtype, dev)
    cut_off = kw.pop("cut_off")
    args = (bg, y0, ug0, vg0, h0, f0, bounds_g, nt - 1, cut_off, rtol, 1e-6,
            7.2)
    before = tracer.EXACT_LAUNCHES, rk45.EXACT_LAUNCHES, ray.LAUNCHES
    k = tracer._exact_run(*args, **kw)
    assert (tracer.EXACT_LAUNCHES, rk45.EXACT_LAUNCHES, ray.LAUNCHES) == (
        before[0] + 1, before[1], before[2])
    p = tracer._exact_run_plain(*args, **kw)
    assert k.ys.shape == (nt, 5, y0.shape[1])
    for a, b in zip(k[:3] + k.carry, p[:3] + p.carry):
        assert same(a, b)
    assert torch.equal(k.lane_att, p.lane_att)
    assert torch.equal(k.trunc, p.trunc)
    if case == "maxiters":
        assert int(k.trunc.sum()) > 0
    if case == "cutoff":
        assert (torch.isnan(k.ys[-1, 0]) & ~torch.isnan(y0[3])).any()


INSTANCES = list(kernels.INSTANCES)
#: Lane counts of the instance tests: the 207 lanes of dense_run_inputs
#: and their first 37 (neither a multiple of 8, 32 or 128).
LANES = [207, 37]


def lanes(xs, n):
    return [x[..., :n].contiguous() for x in xs]


@pytest.mark.parametrize("n", LANES)
@pytest.mark.parametrize("instance", INSTANCES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_rk4_instances_equal_plain(jet_field, dev, dtype, instance, n):
    """Every instance of the RK4 kernel (one thread per lane, a team of 8
    threads per lane) gives the plain loop's rows, (ug, vg) and
    carry bitwise; rootless lanes and kills included."""
    _, bg = background(jet_field, dtype, dev)
    (y0, ug0, vg0, *_), _ = dense_run_inputs(bg, dtype, dev)
    y0, ug0, vg0 = lanes((amp_nan(y0), ug0, vg0), n)
    k = tracer._run_rk4_cuda(bg, y0, ug0, vg0, 7200.0, 25, 0.03, instance)
    p = tracer._run_rk4_plain(bg, y0, ug0, vg0, 7200.0, 25, 0.03)
    for a, b in zip(k, p):
        assert same(a, b)
    assert torch.isnan(k[0][-1, 0]).any() and torch.isfinite(k[0][-1, 0]).any()


@pytest.mark.parametrize("n", LANES)
@pytest.mark.parametrize("instance", INSTANCES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_exact_group_instances_equal_plain(jet_field, dev, dtype, instance,
                                           n):
    """Every instance of the single-group exact kernel against the plain
    loop, stopped after 7 trips and resumed: the lanes of a warp leave the
    loop at different trips, NaN-amp and rootless lanes included."""
    _, bg = background(jet_field, dtype, dev)
    (y0, _, _, h0, _, _, _), rtol = dense_run_inputs(bg, dtype, dev)
    y0, h0 = lanes((amp_nan(y0), h0), n)
    f0 = ray.RayRHS(bg)(y0)
    bounds = torch.arange(1, 11, dtype=dtype, device=dev) * 7200.0
    carry = (y0, torch.zeros_like(h0), h0, f0, y0[0].clone(), y0[1].clone())

    def plain_rhs(yy, tt=0.0):
        return ray._rhs_core(bg, yy, tt, False)[0]

    def plain_gv(yy, tt=0.0):
        dy, _, ug, vg = ray._rhs_core(bg, yy, tt, True)
        return dy, ug, vg

    def run(kernel, carry, max_iters, state0=None):
        if kernel:
            return rk45._integrate_group_cuda(
                ray.RayRHS(bg), None, *carry[:4], bounds, *carry[4:], 0.03,
                rtol, 1e-6, 7.2, max_iters, state0, instance)
        return rk45._integrate_group_plain(
            plain_rhs, plain_gv, *carry[:4], bounds, *carry[4:], 0.03, rtol,
            1e-6, 7.2, max_iters, state0)

    k, p = run(True, carry, 7), run(False, carry, 7)
    tails = [[x[i] for i in (0, 10, 11, 9, 12)] for x in (k, p)]
    k = run(True, k[1:7], 1_000_000, tails[0])
    p = run(False, p[1:7], 1_000_000, tails[1])
    for i in range(7):
        assert same(k[i], p[i]), i
    assert int(k[7]) == p[7]
    for i in (9, 10, 11, 12):
        assert torch.equal(k[i], p[i]), i


def overflow(y0):
    """y0 with every born lane's amp at the dtype's largest value: it
    overflows to NaN inside the first interval, dynamics finite."""
    y0 = y0.clone()
    y0[4, torch.isfinite(y0[4])] = torch.finfo(y0.dtype).max
    return y0


EXACT_INSTANCE_CASES = {
    "default": dict(group=5, cut_off=0.2),
    "maxiters": dict(group=5, cut_off=0.2, max_iters=3),
    "barrier": dict(group=1, cut_off=0.2, max_iters=100_000, barrier=True),
    "grouped_overflow": dict(group=1, cut_off=0.2, max_iters=100_000),
}


@pytest.mark.parametrize("case", list(EXACT_INSTANCE_CASES))
@pytest.mark.parametrize("n", LANES)
@pytest.mark.parametrize("instance", INSTANCES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_exact_run_instances_equal_plain(jet_field, dev, dtype, instance, n,
                                         case):
    """Every instance of the whole-run exact kernel against the plain run,
    bitwise: rows, (ug, vg), attempts, truncation counts and carry. The
    overflow cases run the amp-overflow entry state one bound per group,
    with the barrier flag (what ``_run_rk45`` launches) and without it."""
    _, bg = background(jet_field, dtype, dev)
    kw = dict(EXACT_INSTANCE_CASES[case])
    group, cut_off = kw.pop("group"), kw.pop("cut_off")
    (y0, ug0, vg0, h0, _, _, _), rtol = dense_run_inputs(bg, dtype, dev)
    y0 = overflow(y0) if group == 1 else amp_nan(y0)
    y0, ug0, vg0, h0 = lanes((y0, ug0, vg0, h0), n)
    f0 = ray.RayRHS(bg)(y0)
    bounds_g = tracer.padded_bounds(7200.0, 13, group, dtype, dev)
    args = (bg, y0, ug0, vg0, h0, f0, bounds_g, 12, cut_off, rtol, 1e-6, 7.2)
    k = tracer._exact_run_cuda(*args, instance=instance, **kw)
    p = tracer._exact_run_plain(*args, **kw)
    for a, b in zip(k[:3] + k.carry, p[:3] + p.carry):
        assert same(a, b)
    assert torch.equal(k.lane_att, p.lane_att)
    assert torch.equal(k.trunc, p.trunc)


def test_exact_and_rk4_wrappers_refuse_bad_inputs(jet_field, dev):
    _, bg = background(jet_field, torch.float32, dev)
    (y0, ug0, vg0, h0, f0, bounds_g, n_bounds), rtol = dense_run_inputs(
        bg, torch.float32, dev)
    good = [bg, y0, ug0, vg0, h0, f0, bounds_g, n_bounds, 0.2, rtol, 1e-6,
            7.2]
    for pos, bad in ((1, y0.double()), (4, h0[:-1]),
                     (6, bounds_g.reshape(-1)), (7, bounds_g.numel() + 1)):
        args = list(good)
        args[pos] = bad
        with pytest.raises(ValueError):
            tracer._exact_run(*args)
    ys, ugs, vgs = tracer._rk4_buffers(y0, 5)
    with pytest.raises(ValueError):   # ug0 without vg0
        tracer._rk4_launch(bg, y0, 7200.0, 4, 0.2, ys, ugs, vgs, 1, ug0, None)
    with pytest.raises(ValueError):   # rows past the output
        tracer._rk4_launch(bg, y0, 7200.0, 5, 0.2, ys, ugs, vgs, 1)
    with pytest.raises(ValueError):   # row 0 needs row_offset >= 1
        tracer._rk4_launch(bg, y0, 7200.0, 4, 0.2, ys, ugs, vgs, 0, ug0, vg0)
    with pytest.raises(TypeError):
        rk45.integrate_group(lambda yy, tt=0.0: yy, None, y0, h0, h0, f0,
                             bounds_g[0], h0, h0, 0.2, rtol, 1e-6, 7.2)
    with pytest.raises(ValueError):   # no such instance
        tracer._run_rk4_cuda(bg, y0, ug0, vg0, 7200.0, 5, 0.2, "team16")


SPECTRAL_BARS = {"float64": 1e-12, "float64_bf16": 1e-12, "float32": 1e-5,
                 "bf16": 1e-5}
#: The operand dtype of each case (the rest: float32 or float64 coefficients
#: with the named ``matmul_dtype``).
SPECTRAL_MM = {"float64": None, "float64_bf16": torch.bfloat16,
               "float32": None, "bf16": torch.bfloat16}
for _mm in ("float16", "float8_e4m3fn", "float8_e5m2", "float8_e4m3fnuz",
            "float8_e5m2fnuz", "float32"):
    for _dt, _bar in (("float32", 1e-5), ("float64", 1e-12)):
        if _mm != _dt:
            SPECTRAL_BARS[f"{_dt}_{_mm}"] = _bar
            SPECTRAL_MM[f"{_dt}_{_mm}"] = getattr(torch, _mm)


@pytest.mark.parametrize("n_rays", [1, 127, 129, 3000])
@pytest.mark.parametrize("n_fields", [1, 12, 18])
@pytest.mark.parametrize("trunc", [(None, None), (9, 11), (0, None),
                                   (None, 1)],
                         ids=["full", "m9_l11", "m0", "l1"])
@pytest.mark.parametrize("case", list(SPECTRAL_BARS))
def test_spectral_kernel_matches_plain(jet_field, dev, case, trunc, n_fields,
                                       n_rays):
    """Every truncation the JAX kernel serves (m_max 0 is Mp = 1, l_max 1 a
    single latitude mode), C of 1 to 18, ragged R, and NaN lon, NaN lat and
    |lat| > pi/2 rows, in every operand case; max |diff| over each
    channel's max |value| on the 3000 points, over the values finite in
    both, the non-finite ones (a cast's overflow) where the plain
    version's are."""
    dtype = torch.float32 if case in ("float32", "bf16") or case.startswith(
        "float32_") else torch.float64
    bs, _ = background(jet_field, dtype, dev)
    fit = spec.fit_spectral(bs, m_max=trunc[0], l_max=trunc[1])
    sbg = spec.SpectralBackground(fit.coeffs[..., :n_fields].contiguous(),
                                  fit.lat0)
    rng = np.random.default_rng(12)
    lon = torch.as_tensor(rng.uniform(-1, 7, 3000), dtype=dtype, device=dev)
    lat = torch.as_tensor(rng.uniform(-1.6, 1.6, 3000), dtype=dtype,
                          device=dev)
    lat[0] = 0.3                         # row 0 in range, for R = 1
    lon[1:6] = float("nan")
    lat[6:9] = float("nan")
    lat[9], lat[10] = 1.58, -1.6         # |lat| > pi/2
    mm = SPECTRAL_MM[case]
    scale = torch.nan_to_num(
        spec.sample_spectral(sbg, lon, lat, matmul_dtype=mm).abs(),
        posinf=0.0).amax(0)
    lon, lat = lon[:n_rays], lat[:n_rays]
    before = spec.LAUNCHES
    k = spec.sample_spectral_cuda(sbg, lon, lat, matmul_dtype=mm)
    assert spec.LAUNCHES == before + 1
    p = spec.sample_spectral(sbg, lon, lat, matmul_dtype=mm)
    assert k.shape == (n_rays, n_fields)
    assert torch.equal(torch.isnan(k), torch.isnan(p))
    assert torch.equal(torch.isinf(k), torch.isinf(p))
    assert torch.equal(k[torch.isinf(k)], p[torch.isinf(p)])
    if n_rays > 10:
        # NaN lat and |lat| > pi/2 rows; NaN lon rows too, except at
        # m_max = 0, whose lon basis is the constant 1.
        assert torch.isnan(k[6:11]).all()
        assert torch.isnan(k[1:6]).all() == (trunc[0] != 0)
    # Channels that vanish at this truncation (lon derivatives at m_max = 0)
    # have scale 0 and must come out exactly 0.
    diff = torch.where(torch.isfinite(p), (k - p).abs(), 0.0)
    err = torch.where(diff == 0, 0.0, diff / scale).max()
    assert float(err) <= SPECTRAL_BARS[case]
    # A fixed summation order: a second launch is bitwise equal.
    assert same(k, spec.sample_spectral_cuda(sbg, lon, lat, matmul_dtype=mm))


def test_spectral_wrapper_refuses_other_matmul_dtypes(jet_field, dev):
    """A non-floating dtype, and a floating one that JAX does not take,
    raise ValueError before any launch; the coefficients' own dtype and a
    wider one are the no-rounding case, bitwise None's; every served dtype
    launches the kernel once."""
    bs, _ = background(jet_field, torch.float32, dev)
    sbg = spec.fit_spectral(bs)
    lon = torch.zeros(4, device=dev)
    before = spec.LAUNCHES
    for bad in (torch.int8, torch.bool, torch.float8_e8m0fnu):
        with pytest.raises(ValueError):
            spec.sample_spectral_cuda(sbg, lon, lon, matmul_dtype=bad)
    assert spec.LAUNCHES == before
    none = spec.sample_spectral_cuda(sbg, lon, lon)
    for wide in (torch.float32, torch.float64):
        assert same(none, spec.sample_spectral_cuda(sbg, lon, lon,
                                                    matmul_dtype=wide))
    before = spec.LAUNCHES
    for mm in spec.OPERAND_DTYPES:
        spec.sample_spectral_cuda(sbg, lon, lon, matmul_dtype=mm)
    assert spec.LAUNCHES == before + len(spec.OPERAND_DTYPES)


@pytest.mark.parametrize("mm", list(spec.OPERAND_DTYPES), ids=str)
@pytest.mark.parametrize("dtype", DTYPES)
def test_spectral_rounding_equals_round_operands(dev, dtype, mm):
    """The kernel's operand rounding (``rwrt_spectral_round``, the device
    function its prologue rounds the basis with) equals the plain
    ``round_operands`` bitwise, the sign of zero included, NaN where NaN:
    on [-1, 1] uniform, log-uniform magnitudes past every subnormal range,
    exact ties and the specials."""
    g = torch.Generator(device=dev).manual_seed(13)
    n = 1 << 20
    u = torch.rand(n, device=dev, dtype=torch.float64, generator=g) * 2 - 1
    mag = torch.exp2(-40 * torch.rand(n, device=dev, dtype=torch.float64,
                                      generator=g))
    ties = (torch.randint(0, 1 << 11, (n,), device=dev, generator=g) + 0.5
            ) * torch.exp2(-torch.randint(0, 40, (n,), device=dev,
                                          generator=g).double()) / 2048
    x = torch.cat([u, mag * torch.sign(u), ties, -ties,
                   torch.tensor([0.0, -0.0, float("inf"), -float("inf"),
                                 float("nan"), 1.0, -1.0, 1e5, -1e5],
                                dtype=torch.float64, device=dev)]).to(dtype)
    got = spec.round_on_card(x, mm)
    want = spec.round_operands(x, mm)
    int_type = torch.int32 if dtype == torch.float32 else torch.int64
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(torch.where(nan, 0, got).view(int_type),
                       torch.where(nan, 0, want).view(int_type))


def test_trace_rays_on_cuda_goes_through_the_kernels(jet_field, dev):
    u, v, lat, lon = jet_field
    bs = pt.prepare(u, v, lat, lon, cal_dtype="float32", device=dev)
    cfg = pt.RunConfig(zwn=(2.0, 4.0, 6.0), sw_lon=0.0, sw_lat=5.0,
                       dlon=36.0, dlat=8.0, nnx=5, nny=4, tstep=7200.0,
                       ttotal=4 * 86400.0, integrator="rk45",
                       bound_mode="dense", interval_batch=16, pin_limit=500,
                       pin_mwn=0.0)
    r0, d0, t0 = ray.LAUNCHES, rk45.LAUNCHES, tracer.LAUNCHES
    e0 = tracer.ENTRY_LAUNCHES
    out = pt.trace_rays(bs, cfg)
    # One entry-stage launch for the set-up (f0 and h0), no RHS launch,
    # one whole-run dense launch, and no single-group launch.
    assert tracer.ENTRY_LAUNCHES == e0 + 1 and ray.LAUNCHES == r0
    assert tracer.LAUNCHES == t0 + 1
    assert rk45.LAUNCHES == d0
    assert out.lon.shape == (49, 3, 20, 3) and out.lon.is_cuda
    alive = torch.isfinite(out.ky[-1])
    assert alive.any() and torch.isfinite(out.lat[-1][alive]).all()


@pytest.mark.parametrize("branch", ["rk4", "exact", "exact_batch1"])
def test_trace_rays_other_branches_launch_once(jet_field, dev, branch):
    """rk4 and exact mode on the card: one launch of the branch's kernel,
    no dense launch, finite rows on the lanes alive at the end; exact mode
    one entry-stage launch before it and no RHS launch."""
    u, v, lat, lon = jet_field
    bs = pt.prepare(u, v, lat, lon, cal_dtype="float32", device=dev)
    cfg = pt.RunConfig(
        zwn=(2.0, 4.0, 6.0), sw_lon=0.0, sw_lat=5.0, dlon=36.0, dlat=8.0,
        nnx=5, nny=4, tstep=7200.0, ttotal=4 * 86400.0,
        integrator="rk4" if branch == "rk4" else "rk45",
        interval_batch=1 if branch == "exact_batch1" else 16)
    before = (tracer.LAUNCHES, tracer.RK4_LAUNCHES, tracer.EXACT_LAUNCHES,
              tracer.ENTRY_LAUNCHES, ray.LAUNCHES)
    stats = {}
    out = pt.trace_rays(bs, cfg, stats=stats)
    after = (tracer.LAUNCHES, tracer.RK4_LAUNCHES, tracer.EXACT_LAUNCHES,
             tracer.ENTRY_LAUNCHES, ray.LAUNCHES)
    want = (0, 1, 0, 0, 0) if branch == "rk4" else (0, 0, 1, 1, 0)
    assert tuple(a - b for a, b in zip(after, before)) == want
    assert ("lane_att" in stats) == (branch != "rk4")
    assert out.lon.shape == (49, 3, 20, 3) and out.lon.is_cuda
    alive = torch.isfinite(out.ky[-1])
    assert alive.any() and torch.isfinite(out.lat[-1][alive]).all()


def test_wrappers_refuse_bad_inputs(jet_field, dev):
    _, bg = background(jet_field, torch.float32, dev)
    y = seeded_states(torch.float64, dev, n=64)
    # A float64 state over float32 fields (mixed precision) is rounded to
    # float32 at entry, as the plain RHS rounds it.
    for a, b in zip(ray._rhs_cuda(bg, y, False),
                    ray._rhs_cuda(bg, y.float(), False)):
        if a is not None:
            assert same(a, b) if a.is_floating_point() else torch.equal(a, b)
    with pytest.raises(ValueError):
        ray._rhs_cuda(bg, y.float().T.contiguous().T, False)  # layout
    with pytest.raises(TypeError):
        yf = y.float().contiguous()
        rk45.integrate_group_dense(
            lambda yy, tt=0.0: yy, yf, yf[0], yf[0], yf,
            torch.ones(3, device=dev), 1e-5, 1e-6, 7.2)


# ---- Mixed precision: a float64 state over a float32 background. ----

MIXED = (torch.float64, torch.float32)


def mixed_inputs(jet_field, dev, group=5, nt=13):
    _, bg = background(jet_field, torch.float32, dev)
    return (bg,) + dense_run_inputs(bg, torch.float32, dev, group, nt,
                                    state=torch.float64)


@pytest.mark.parametrize("case", list(DENSE_RUN_CASES))
def test_dense_run_mixed_equals_plain(jet_field, dev, case):
    """The whole-run dense kernel's mixed instance: one launch; rows, ug,
    vg, attempts, truncation counts and carry (f in float32, the rest in
    float64) bitwise equal to the plain run."""
    bg, (y0, ug0, vg0, h0, f0, bounds_g, n_bounds), rtol = mixed_inputs(
        jet_field, dev)
    assert (y0.dtype, f0.dtype, ug0.dtype) == MIXED + (torch.float32,)
    kw = dict(DENSE_RUN_CASES[case])
    cut_off = kw.pop("cut_off")
    args = (bg, y0, ug0, vg0, h0, f0, bounds_g, n_bounds, cut_off, rtol,
            1e-6, 7.2)
    before = tracer.LAUNCHES
    k = tracer._dense_run(*args, **kw)
    assert tracer.LAUNCHES == before + 1
    p = tracer._dense_run_plain(*args, **kw)
    assert k.ys.dtype == k.ugs.dtype == torch.float64
    assert k.carry[3].dtype == torch.float32
    for a, b in zip(k[:3] + k.carry, p[:3] + p.carry):
        assert a.dtype == b.dtype and same(a, b)
    assert torch.equal(k.lane_att, p.lane_att)
    assert torch.equal(k.trunc, p.trunc)


@pytest.mark.parametrize("n", LANES)
@pytest.mark.parametrize("instance", INSTANCES)
def test_rk4_mixed_instances_equal_plain(jet_field, dev, instance, n):
    """Every instance of the RK4 kernel's mixed instance against the plain
    loop: rows, (ug, vg) bitwise, float64; and a chunk from a carry."""
    bg, (y0, ug0, vg0, *_), _ = mixed_inputs(jet_field, dev)
    y0, ug0, vg0 = lanes((amp_nan(y0), ug0, vg0), n)
    k = tracer._run_rk4_cuda(bg, y0, ug0, vg0, 7200.0, 25, 0.03, instance)
    p = tracer._run_rk4_plain(bg, y0, ug0, vg0, 7200.0, 25, 0.03)
    for a, b in zip(k, p):
        assert a.dtype == torch.float64 and same(a, b)
    assert torch.isnan(k[0][-1, 0]).any() and torch.isfinite(k[0][-1, 0]).any()
    carry = k[0][10].contiguous()
    outs = tracer._rk4_buffers(carry, 6)
    y_k = tracer._rk4_launch(bg, carry, 7200.0, 6, 0.03, *outs, 0,
                             instance=instance)
    ref = tracer._rk4_buffers(carry, 6)
    y_p = rk4.trace_into(bg, carry, 7200.0, 6, 0.03, *ref)
    for a, b in zip(outs + (y_k,), ref + (y_p,)):
        assert same(a, b)


@pytest.mark.parametrize("case", list(EXACT_INSTANCE_CASES))
@pytest.mark.parametrize("n", LANES)
@pytest.mark.parametrize("instance", INSTANCES)
def test_exact_run_mixed_instances_equal_plain(jet_field, dev, instance, n,
                                               case):
    """Every instance of the whole-run exact kernel's mixed instance, grouped
    and with the barrier flag (whose (ug, vg) are sampled at the saved
    state in float64), against the plain run, bitwise."""
    kw = dict(EXACT_INSTANCE_CASES[case])
    group, cut_off = kw.pop("group"), kw.pop("cut_off")
    bg, (y0, ug0, vg0, h0, _, _, _), rtol = mixed_inputs(jet_field, dev)
    y0 = overflow(y0) if group == 1 else amp_nan(y0)
    y0, ug0, vg0, h0 = lanes((y0, ug0, vg0, h0), n)
    f0 = ray.RayRHS(bg)(y0)
    bounds_g = tracer.padded_bounds(7200.0, 13, group, torch.float64, dev)
    args = (bg, y0, ug0, vg0, h0, f0, bounds_g, 12, cut_off, rtol, 1e-6, 7.2)
    k = tracer._exact_run_cuda(*args, instance=instance, **kw)
    p = tracer._exact_run_plain(*args, **kw)
    for a, b in zip(k[:3] + k.carry, p[:3] + p.carry):
        assert a.dtype == b.dtype and same(a, b)
    assert torch.equal(k.lane_att, p.lane_att)
    assert torch.equal(k.trunc, p.trunc)


def test_single_group_kernels_refuse_mixed(jet_field, dev):
    """``integrate_group`` and ``integrate_group_dense`` on a mixed state
    (their ``_mix`` instances, which once refused it): one launch each,
    every output bitwise equal to the plain loop, the rows and carry in
    float64 and f in float32."""
    bg, (y0, _, _, h0, f0, bounds_g, _), rtol = mixed_inputs(jet_field, dev)
    y0 = amp_nan(y0)
    f0 = ray.RayRHS(bg)(y0)
    t0 = torch.zeros_like(h0)
    bounds = torch.cat([bounds_g[0], bounds_g[1]])

    def plain_rhs(yy, tt=0.0):
        return ray._rhs_core(bg, yy, tt, False)[0]

    def plain_gv(yy, tt=0.0):
        dy, _, ug, vg = ray._rhs_core(bg, yy, tt, True)
        return dy, ug, vg

    before = rk45.EXACT_LAUNCHES
    k = rk45.integrate_group(ray.RayRHS(bg), None, y0, t0, h0, f0, bounds,
                             y0[0].clone(), y0[1].clone(), 0.03, rtol, 1e-6,
                             7.2)
    assert rk45.EXACT_LAUNCHES == before + 1
    p = rk45._integrate_group_plain(plain_rhs, plain_gv, y0, t0, h0, f0,
                                    bounds, y0[0], y0[1], 0.03, rtol, 1e-6,
                                    7.2)
    assert k[0].dtype == torch.float64 and k[4].dtype == torch.float32
    for i in range(7):
        assert k[i].dtype == p[i].dtype and same(k[i], p[i]), i
    assert int(k[7]) == p[7]
    for i in (9, 10, 11, 12):
        assert torch.equal(k[i], p[i]), i
    before = rk45.LAUNCHES
    k = rk45.integrate_group_dense(ray.RayRHS(bg), y0, t0, h0, f0, bounds,
                                   rtol, 1e-6, 7.2, pin_limit=40, pin_mwn=0.0)
    assert rk45.LAUNCHES == before + 1
    p = rk45._integrate_group_dense_plain(plain_rhs, y0, t0, h0, f0, bounds,
                                          rtol, 1e-6, 7.2, 1_000_000, 40, 0.0)
    assert k[0].dtype == torch.float64 and k[4].dtype == torch.float32
    for i in (0, 1, 2, 3, 4):
        assert k[i].dtype == p[i].dtype and same(k[i], p[i]), i
    for i in (7, 8, 9):
        assert torch.equal(k[i], p[i]), i
    assert int(k[5]) == p[5]


@pytest.mark.parametrize("branch", ["rk4", "exact", "exact_batch1", "dense"])
def test_trace_rays_mixed_launches_once(jet_field, dev, branch):
    """state_dtype='float64' over a float32 background on the card: one
    launch of the branch's kernel (the adaptive ones after one launch of
    the entry stage's mixed instance, no RHS launch), all seven outputs
    float64, finite rows on the lanes alive at the end."""
    u, v, lat, lon = jet_field
    bs = pt.prepare(u, v, lat, lon, cal_dtype="float32", device=dev)
    cfg = pt.RunConfig(
        zwn=(2.0, 4.0, 6.0), sw_lon=0.0, sw_lat=5.0, dlon=36.0, dlat=8.0,
        nnx=5, nny=4, tstep=7200.0, ttotal=4 * 86400.0,
        integrator="rk4" if branch == "rk4" else "rk45",
        bound_mode="dense" if branch == "dense" else "exact",
        interval_batch=1 if branch == "exact_batch1" else 16,
        state_dtype="float64")
    before = (tracer.LAUNCHES, tracer.RK4_LAUNCHES, tracer.EXACT_LAUNCHES,
              rk45.LAUNCHES, rk45.EXACT_LAUNCHES, tracer.ENTRY_LAUNCHES,
              ray.LAUNCHES)
    out = pt.trace_rays(bs, cfg)
    after = (tracer.LAUNCHES, tracer.RK4_LAUNCHES, tracer.EXACT_LAUNCHES,
             rk45.LAUNCHES, rk45.EXACT_LAUNCHES, tracer.ENTRY_LAUNCHES,
             ray.LAUNCHES)
    want = {"rk4": (0, 1, 0, 0, 0, 0, 0), "dense": (1, 0, 0, 0, 0, 1, 0)}.get(
        branch, (0, 0, 1, 0, 0, 1, 0))
    assert tuple(a - b for a, b in zip(after, before)) == want
    for name in out._fields:
        assert getattr(out, name).dtype == torch.float64, name
    assert out.lon.shape == (49, 3, 20, 3) and out.lon.is_cuda
    alive = torch.isfinite(out.ky[-1])
    assert alive.any() and torch.isfinite(out.lat[-1][alive]).all()


@pytest.mark.parametrize("state", ["compute", "float64"],
                         ids=["float32", "mixed"])
@pytest.mark.parametrize("branch", ["rk4", "exact", "exact_batch1", "dense"])
def test_chunked_driver_launches_once_per_chunk(jet_field, dev, branch,
                                                state):
    """``trace_rays_chunked`` on the card: one launch of the branch's
    whole-run kernel per chunk and no other integrator launch (the
    adaptive ones one entry-stage launch at the start, no RHS launch); with
    chunk_steps equal to the group, compaction off, rows bitwise equal to
    ``trace_rays``' (host tensors)."""
    from rwrt_tpu_torch.utils import checkpoint

    u, v, lat, lon = jet_field
    bs = pt.prepare(u, v, lat, lon, cal_dtype="float32", device=dev)
    cfg = pt.RunConfig(
        zwn=(2.0, 4.0, 6.0), sw_lon=0.0, sw_lat=5.0, dlon=36.0, dlat=8.0,
        nnx=5, nny=4, tstep=7200.0, ttotal=4 * 86400.0,
        integrator="rk4" if branch == "rk4" else "rk45",
        bound_mode="dense" if branch == "dense" else "exact",
        interval_batch=1 if branch == "exact_batch1" else 8,
        compact_dead=False, state_dtype=state)
    want = pt.trace_rays(bs, cfg)
    before = (tracer.LAUNCHES, tracer.RK4_LAUNCHES, tracer.EXACT_LAUNCHES,
              rk45.LAUNCHES, rk45.EXACT_LAUNCHES, tracer.ENTRY_LAUNCHES,
              ray.LAUNCHES)
    got = checkpoint.trace_rays_chunked(bs, cfg, chunk_steps=8,
                                        verbose=False)
    after = (tracer.LAUNCHES, tracer.RK4_LAUNCHES, tracer.EXACT_LAUNCHES,
             rk45.LAUNCHES, rk45.EXACT_LAUNCHES, tracer.ENTRY_LAUNCHES,
             ray.LAUNCHES)
    want_launches = {"rk4": (0, 6, 0, 0, 0, 0, 0),
                     "dense": (6, 0, 0, 0, 0, 1, 0)}.get(
        branch, (0, 0, 6, 0, 0, 1, 0))
    assert tuple(a - b for a, b in zip(after, before)) == want_launches
    for name in want._fields:
        a, b = getattr(want, name), getattr(got, name)
        assert b.device.type == "cpu" and a.dtype == b.dtype, name
        assert same(a.cpu(), b), name


# ---- Time-varying and ensemble backgrounds: the time instances ----

DAY = 86400.0
#: The (state, field) dtypes of the time instances' tests.
KEYS = {"float32": (torch.float32, torch.float32),
        "float64": (torch.float64, torch.float64),
        "mixed": (torch.float64, torch.float32)}
#: Backgrounds: time-varying; an ensemble of static members; an ensemble
#: of time-varying members.
KINDS = ["time", "member", "member_time"]


def frames(jet_field, nt=5, scale=1.0):
    """nt daily-ish wind frames: the jet's amplitude varies and the wave
    drifts east, frame by frame (a member's ``scale`` multiplies u)."""
    u, v, lat, lon = jet_field
    fu = np.stack([scale * (1.0 + 0.15 * np.sin(k)) * u for k in range(nt)])
    fv = np.stack([np.roll(v, 2 * k, axis=0) for k in range(nt)])
    return fu, fv, lat, lon


def varying_background(jet_field, kind, dtype, dev, lanes_=None):
    """A ``kind`` background on the card, its frames 0.2 days apart from
    -0.3 days (so the 1-day runs below cross every frame and pass the
    last); with ``lanes_``, an ensemble's member map cycles over the
    members lane by lane."""
    def state(scale=1.0):
        fu, fv, lat, lon = frames(jet_field, scale=scale)
        if kind == "member":
            return pt.prepare(fu[0], fv[0], lat, lon, cal_dtype=dtype,
                              device=dev)
        return pt.prepare_time_varying(fu, fv, lat, lon, bg_t0=-0.3 * DAY,
                                       bg_dt=0.2 * DAY, cal_dtype=dtype,
                                       device=dev)

    if kind == "time":
        return tracer.make_background(state(), 0.0)
    members = [tracer.make_background(state(s), 0.0) for s in (0.9, 1.1,
                                                                1.0)]
    ids = torch.arange(lanes_, device=dev, dtype=torch.int32) % len(members)
    return members[0]._replace(
        fields=torch.stack([m.fields for m in members]).contiguous(),
        member_ids=ids)


def varying_inputs(jet_field, kind, key, dev, n=207):
    """``dense_run_inputs`` over a ``kind`` background (the static jet
    seeds the lanes), cut to n lanes, with h0 and f0 from the varying
    background at t = 0."""
    state, field = KEYS[key]
    _, bg0 = background(jet_field, field, dev)
    (y0, ug0, vg0, *_), rtol = dense_run_inputs(bg0, field, dev,
                                                state=state)
    y0, ug0, vg0 = lanes((y0, ug0, vg0), n)
    bg = varying_background(jet_field, kind, field, dev, n)
    h0 = tracer.initial_step_sizes(bg, y0, rtol, 1e-6)
    return bg, y0, ug0, vg0, h0, rtol


@pytest.mark.parametrize("gv", [False, True])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_rhs_time_instance_equals_plain(jet_field, dev, dtype, kind, gv):
    """The RHS kernel's time instance at per-lane times over every frame,
    between them and past both ends: bitwise equal to ``_rhs_core``."""
    y = seeded_states(dtype, dev)
    bg = varying_background(jet_field, kind, dtype, dev, y.shape[1])
    rng = np.random.default_rng(3)
    t = rng.uniform(-1.0 * DAY, 1.5 * DAY, y.shape[1])
    t[:40] = -0.3 * DAY + 0.2 * DAY * np.arange(40)  # on the frames, past
    t = torch.as_tensor(t, dtype=dtype, device=dev)
    before = ray.LAUNCHES
    if gv:
        k = ray.rhs_and_gv(bg, y, t)
        p = ray._rhs_core(bg, y, t, True)
        p = (p[0], p[2], p[3])
    else:
        k = ray.rhs(bg, y, t)
        p = ray._rhs_core(bg, y, t, False)[:2]
    assert ray.LAUNCHES == before + 1
    for a, b in zip(k, p):
        assert same(a, b) if a.is_floating_point() else torch.equal(a, b)


@pytest.mark.parametrize("n", LANES)
@pytest.mark.parametrize("instance", INSTANCES)
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("key", list(KEYS))
def test_rk4_time_instances_equal_plain(jet_field, dev, key, kind, instance,
                                        n):
    """Every instance of the RK4 kernel's time instances against the plain
    loop, bitwise: the whole run, and a chunk entered at step 10's time."""
    bg, y0, ug0, vg0, _, _ = varying_inputs(jet_field, kind, key, dev, n)
    y0 = amp_nan(y0)
    before = tracer.RK4_LAUNCHES
    k = tracer._run_rk4_cuda(bg, y0, ug0, vg0, 7200.0, 13, 0.03, instance)
    assert tracer.RK4_LAUNCHES == before + 1
    p = tracer._run_rk4_plain(bg, y0, ug0, vg0, 7200.0, 13, 0.03)
    for a, b in zip(k, p):
        assert same(a, b)
    carry = k[0][10].contiguous()
    outs = tracer._rk4_buffers(carry, 6)
    y_k = tracer._rk4_launch(bg, carry, 7200.0, 6, 0.03, *outs, 0,
                             instance=instance, t_start=10 * 7200.0)
    ref = tracer._rk4_buffers(carry, 6)
    y_p = rk4.trace_into(bg, carry, 7200.0, 6, 0.03, *ref,
                         t_start=10 * 7200.0)
    for a, b in zip(outs + (y_k,), ref + (y_p,)):
        assert same(a, b)


@pytest.mark.parametrize("case", ["default", "barrier"])
@pytest.mark.parametrize("n", LANES)
@pytest.mark.parametrize("instance", INSTANCES)
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("key", list(KEYS))
def test_exact_run_time_instances_equal_plain(jet_field, dev, key, kind,
                                              instance, n, case):
    """Every instance of the whole-run exact kernel's time instances,
    grouped and with the barrier flag, against the plain run, bitwise."""
    bg, y0, ug0, vg0, h0, rtol = varying_inputs(jet_field, kind, key, dev, n)
    barrier = case == "barrier"
    y0 = overflow(y0) if barrier else amp_nan(y0)
    f0 = ray.RayRHS(bg)(y0)
    bounds_g = tracer.padded_bounds(7200.0, 13, 1 if barrier else 5,
                                    y0.dtype, dev)
    args = (bg, y0, ug0, vg0, h0, f0, bounds_g, 12, 0.2, rtol, 1e-6, 7.2)
    kw = dict(max_iters=100_000, barrier=True) if barrier else {}
    k = tracer._exact_run_cuda(*args, instance=instance, **kw)
    p = tracer._exact_run_plain(*args, **kw)
    for a, b in zip(k[:3] + k.carry, p[:3] + p.carry):
        assert a.dtype == b.dtype and same(a, b)
    assert torch.equal(k.lane_att, p.lane_att)
    assert torch.equal(k.trunc, p.trunc)


@pytest.mark.parametrize("case", ["pin", "nopin", "cutoff"])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("key", list(KEYS))
def test_dense_run_time_instance_equals_plain(jet_field, dev, key, kind,
                                              case):
    """The whole-run dense kernel's time instances: one launch; rows, ug,
    vg (each at its bound's time), attempts, truncation counts and carry
    bitwise equal to the plain run."""
    bg, y0, ug0, vg0, h0, rtol = varying_inputs(jet_field, kind, key, dev)
    kw = dict(DENSE_RUN_CASES[case])
    cut_off = kw.pop("cut_off")
    f0 = ray.RayRHS(bg)(y0)
    bounds_g = tracer.padded_bounds(7200.0, 13, 5, y0.dtype, dev)
    args = (bg, y0, ug0, vg0, h0, f0, bounds_g, 12, cut_off, rtol, 1e-6, 7.2)
    before = tracer.LAUNCHES
    k = tracer._dense_run(*args, **kw)
    assert tracer.LAUNCHES == before + 1
    p = tracer._dense_run_plain(*args, **kw)
    for a, b in zip(k[:3] + k.carry, p[:3] + p.carry):
        assert a.dtype == b.dtype and same(a, b)
    assert torch.equal(k.lane_att, p.lane_att)
    assert torch.equal(k.trunc, p.trunc)


def group_time_inputs(jet_field, kind, key, dev):
    """A single group's entry over a ``kind`` background: the 207 lanes
    (NaN-amp lanes among them) entered at t = 3 h with their RHS there, and
    10 bounds 2 h apart after it, so every stage samples between frames."""
    bg, y0, _, _, h0, rtol = varying_inputs(jet_field, kind, key, dev)
    y0 = amp_nan(y0)
    t0 = torch.full_like(h0, 3 * 3600.0)
    f0 = ray.RayRHS(bg)(y0, t0)
    bounds = (torch.arange(1, 11, dtype=y0.dtype, device=dev) * 7200.0
              + 3 * 3600.0)
    return bg, y0, t0, h0, f0, bounds, rtol


@pytest.mark.parametrize("pin", [None, (40, 0.0)])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("key", list(KEYS))
def test_dense_group_time_instance_equals_plain(jet_field, dev, key, kind,
                                                pin):
    """The single-group dense kernel's time instance (float32, float64,
    mixed) over a time-varying background and ensembles: one launch, every
    output bitwise equal to the plain loop."""
    bg, y0, t0, h0, f0, bounds, rtol = group_time_inputs(jet_field, kind,
                                                         key, dev)
    pin_kw = {} if pin is None else dict(pin_limit=pin[0], pin_mwn=pin[1])
    before = rk45.LAUNCHES
    k = rk45.integrate_group_dense(ray.RayRHS(bg), y0, t0, h0, f0, bounds,
                                   rtol, 1e-6, 7.2, **pin_kw)
    assert rk45.LAUNCHES == before + 1
    plain_rhs = lambda yy, tt=0.0: ray._rhs_core(bg, yy, tt, False)[0]  # noqa: E731
    p = rk45._integrate_group_dense_plain(
        plain_rhs, y0, t0, h0, f0, bounds, rtol, 1e-6, 7.2, 1_000_000,
        **pin_kw)
    for i in (0, 1, 2, 3, 4):
        assert k[i].dtype == p[i].dtype and same(k[i], p[i]), i
    for i in (7, 8, 9):
        assert torch.equal(k[i], p[i]), i
    assert int(k[5]) == p[5]


@pytest.mark.parametrize("resume", [False, True])
@pytest.mark.parametrize("instance", INSTANCES)
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("key", list(KEYS))
def test_exact_group_time_instances_equal_plain(jet_field, dev, key, kind,
                                                instance, resume):
    """Every instance of the single-group exact kernel's time instance
    (float32, float64, mixed) over a time-varying background and
    ensembles, NaN-amp lanes included; with resume, both versions stop
    after 7 trips and resume from their own state: bitwise equal."""
    bg, y0, t0, h0, f0, bounds, rtol = group_time_inputs(jet_field, kind,
                                                         key, dev)
    carry = (y0, t0, h0, f0, y0[0].clone(), y0[1].clone())

    def plain_rhs(yy, tt=0.0):
        return ray._rhs_core(bg, yy, tt, False)[0]

    def plain_gv(yy, tt=0.0):
        dy, _, ug, vg = ray._rhs_core(bg, yy, tt, True)
        return dy, ug, vg

    def run(kernel, carry, max_iters, state0=None):
        if kernel:
            return rk45._integrate_group_cuda(
                ray.RayRHS(bg), None, *carry[:4], bounds, *carry[4:], 0.03,
                rtol, 1e-6, 7.2, max_iters, state0, instance=instance)
        return rk45._integrate_group_plain(
            plain_rhs, plain_gv, *carry[:4], bounds, *carry[4:], 0.03, rtol,
            1e-6, 7.2, max_iters, state0)

    before = rk45.EXACT_LAUNCHES
    k = run(True, carry, 7 if resume else 1_000_000)
    assert rk45.EXACT_LAUNCHES == before + 1
    p = run(False, carry, 7 if resume else 1_000_000)
    if resume:
        tails = [[x[i] for i in (0, 10, 11, 9, 12)] for x in (k, p)]
        k = run(True, k[1:7], 1_000_000, tails[0])
        p = run(False, p[1:7], 1_000_000, tails[1])
    for i in range(7):
        assert k[i].dtype == p[i].dtype and same(k[i], p[i]), i
    assert int(k[7]) == p[7]
    for i in (9, 10, 11, 12):
        assert torch.equal(k[i], p[i]), i


def test_group_time_instances_launch_through_the_entry_points(jet_field,
                                                              dev):
    """``integrate_group`` and ``integrate_group_dense`` take a
    time-varying background on the card through their time instances
    (one launch each, no plain fall-back)."""
    bg, y0, t0, h0, f0, bounds, rtol = group_time_inputs(
        jet_field, "time", "float32", dev)
    before = (rk45.LAUNCHES, rk45.EXACT_LAUNCHES)
    rk45.integrate_group(ray.RayRHS(bg), None, y0, t0, h0, f0, bounds,
                         y0[0].clone(), y0[1].clone(), 0.03, rtol, 1e-6, 7.2)
    rk45.integrate_group_dense(ray.RayRHS(bg), y0, t0, h0, f0, bounds, rtol,
                               1e-6, 7.2)
    assert (rk45.LAUNCHES, rk45.EXACT_LAUNCHES) == (before[0] + 1,
                                                    before[1] + 1)


TIME_CFG = dict(zwn=(2.0, 4.0, 6.0), sw_lon=0.0, sw_lat=5.0, dlon=36.0,
                dlat=8.0, nnx=5, nny=4, tstep=7200.0, ttotal=2 * DAY)


def branch_config(branch, **kw):
    return pt.RunConfig(
        integrator="rk4" if branch == "rk4" else "rk45",
        bound_mode="dense" if branch.startswith("dense") else "exact",
        interval_batch=1 if branch == "exact_batch1" else 8,
        pin_limit=500 if branch == "dense_pin" else None, pin_mwn=0.0,
        **dict(TIME_CFG, **kw))


def launch_counts():
    return (tracer.LAUNCHES, tracer.RK4_LAUNCHES, tracer.EXACT_LAUNCHES,
            rk45.LAUNCHES, rk45.EXACT_LAUNCHES)


def launched(before, branch, n=1):
    """The launches since ``before`` of a ``branch`` run of n launches."""
    after = launch_counts()
    want = [0] * 5
    want[{"rk4": 1, "dense": 0, "dense_pin": 0}.get(branch, 2)] = n
    return tuple(a - b for a, b in zip(after, before)) == tuple(want)


BRANCHES = ["rk4", "exact", "exact_batch1", "dense", "dense_pin"]


@pytest.mark.parametrize("state", ["compute", "float64"],
                         ids=["float32", "mixed"])
@pytest.mark.parametrize("branch", BRANCHES)
def test_trace_rays_time_varying_launches_once(jet_field, dev, branch,
                                               state):
    """``trace_rays`` on a time-varying state on the card: one launch of
    the branch's whole-run kernel; the chunked driver one a chunk, its rows
    bitwise equal to the one-launch run's (chunks of the group, no
    compaction)."""
    from rwrt_tpu_torch.utils import checkpoint

    fu, fv, lat, lon = frames(jet_field)
    bs = pt.prepare_time_varying(fu, fv, lat, lon, bg_t0=-0.3 * DAY,
                                 bg_dt=0.2 * DAY, cal_dtype="float32",
                                 device=dev)
    cfg = branch_config(branch, state_dtype=state, compact_dead=False)
    before = launch_counts()
    want = pt.trace_rays(bs, cfg)
    assert launched(before, branch)
    alive = torch.isfinite(want.ky[-1])
    assert alive.any() and torch.isfinite(want.lat[-1][alive]).all()
    before = launch_counts()
    got = checkpoint.trace_rays_chunked(bs, cfg, chunk_steps=8,
                                        verbose=False, sort_rays=True)
    assert launched(before, branch, 3)
    for name in want._fields:
        assert same(getattr(want, name).cpu(), getattr(got, name)), name


@pytest.mark.parametrize("time", [False, True], ids=["static", "varying"])
@pytest.mark.parametrize("branch", BRANCHES)
def test_ensemble_members_equal_their_own_runs(jet_field, dev, branch,
                                               time):
    """``trace_rays_ensemble`` on the card: one launch for all members, and
    each member's rows bitwise equal to its own ``trace_rays``."""
    def member(scale):
        fu, fv, lat, lon = frames(jet_field, scale=scale)
        if not time:
            return pt.prepare(fu[0], fv[0], lat, lon, device=dev)
        return pt.prepare_time_varying(fu, fv, lat, lon, bg_t0=-0.3 * DAY,
                                       bg_dt=0.2 * DAY, device=dev)

    members = [member(s) for s in (0.9, 1.1, 1.0)]
    cfg = branch_config(branch)
    before = launch_counts()
    ens = pt.trace_rays_ensemble(members, cfg)
    assert launched(before, branch)
    for m, traj in zip(members, ens):
        own = pt.trace_rays(m, cfg)
        for name in own._fields:
            assert same(getattr(own, name), getattr(traj, name)), name


def test_shsf_filters_arrays_on_the_card(jet_field, dev):
    """SHSF of an array runs on the card unless asked otherwise, and agrees
    with the CPU's filter to 1e-12 of the field's max |value| (float64; the
    card's FFT and batched product sum in another order)."""
    from rwrt_tpu_torch.diagnostics import spectral

    u, _, lat, _ = jet_field
    got = spectral.shsf(u, lat, 8)
    assert got.device.type == "cuda" and got.dtype == torch.float64
    ref = spectral.shsf(u, lat, 8, device="cpu")
    err = (got.cpu() - ref).abs().max() / ref.abs().max()
    assert err <= 1e-12, err


@pytest.mark.parametrize("kind", ["static", "time"])
@pytest.mark.parametrize("integrator", ["rk4", "rk45"])
def test_classify_evaluates_through_the_rhs_kernel(jet_field, dev,
                                                   integrator, kind):
    """``termination.classify``'s re-run on the card: RK4's one step four
    launches of the RHS kernel (its time instance over daily frames);
    RK45's one entry-stage launch for the initial step and no RHS launch,
    then one launch of the interval kernel for the whole re-run; no other
    kernel; per-lane labels and candidate states equal to the plain RHS's
    run on the card."""
    from rwrt_tpu_torch.diagnostics import flux, termination

    cfg = pt.RunConfig(zwn=(1.0, 3.0, 5.0), sw_lon=0.0, sw_lat=-60.0,
                       dlon=30.0, dlat=10.0, nnx=12, nny=13, tstep=7200.0,
                       ttotal=4 * DAY, integrator=integrator, cut_off=0.02,
                       cal_dtype="float64")
    if kind == "time":
        fu, fv, lat, lon = frames(jet_field)
        bs = pt.prepare_time_varying(fu, fv, lat, lon, bg_t0=0.0,
                                     bg_dt=DAY, cal_dtype="float64",
                                     device=dev)
    else:
        bs, _ = background(jet_field, torch.float64, dev)
    traj = pt.trace_rays(bs, cfg)
    death = termination.analyze(traj).death_step
    assert int(((death >= 1) & (death < cfg.nt)).sum()) > 0
    def counts():
        return (ray.LAUNCHES, rk45.INTERVAL_LAUNCHES, tracer.ENTRY_LAUNCHES,
                rk45.LAUNCHES, rk45.EXACT_LAUNCHES, tracer.LAUNCHES,
                tracer.RK4_LAUNCHES, tracer.EXACT_LAUNCHES, flux.LAUNCHES)

    before = counts()
    ks, ps = {}, {}
    k = termination.cause_labels(traj, bs, cfg, death, stats=ks)
    after = counts()
    moved = tuple(a - b for a, b in zip(after, before))
    assert moved == ((4, 0, 0) if integrator == "rk4" else (0, 1, 1)) + (
        0,) * 6
    p = termination.cause_labels(
        traj, bs, cfg, death,
        rhs=lambda bg, y, t: ray._rhs_core(bg, y, t, False)[:2], stats=ps)
    np.testing.assert_array_equal(k, p)
    assert same(ks["state"], ps["state"])
    if integrator == "rk45":
        assert torch.equal(ks["lane_att"], ps["lane_att"])


def interval_inputs(jet_field, kind, dtype, dev):
    """Lanes for the interval kernel: the 36 x 17 source matrix x zwn 1..7
    (4,284 lanes, the rootless ones NaN at entry) over the static jet or
    its frames (``varying_background``), each from its own time in the
    first half day to a bound 1 to 6 output steps later, one lane at its
    bound, one past it, one with a NaN lon; h0 from the plain initial
    step. Returns (bg, y, t0, h0, bound)."""
    _, bg0 = background(jet_field, dtype, dev)
    slon, slat = tracer.source_matrix(0.0, -40.0, 10.0, 5.0, 36, 17)
    y, _, _ = tracer.initialize(
        bg0, torch.as_tensor(slon, dtype=dtype, device=dev),
        torch.as_tensor(slat, dtype=dtype, device=dev),
        torch.arange(1, 8, dtype=dtype, device=dev))
    y = y.contiguous()
    r = y.shape[1]
    bg = (bg0 if kind == "static"
          else varying_background(jet_field, kind, dtype, dev))
    rng = np.random.default_rng(23)
    t0 = rng.uniform(0.0, 0.5 * DAY, r)
    bound = t0 + rng.integers(1, 7, r) * 7200.0
    live = np.flatnonzero(torch.isfinite(y.mean(0)).cpu().numpy())
    bound[live[0]] = t0[live[0]]
    bound[live[1]] = t0[live[1]] - 7200.0
    y[0, int(live[2])] = float("nan")
    t0, bound = (torch.as_tensor(x, dtype=dtype, device=dev)
                 for x in (t0, bound))

    def rhs(yy, tt=0.0):
        return ray._rhs_core(bg, yy, tt, False)[0]

    rtol = rk45.validate_tol(1e-6, dtype)
    h0 = rk45.select_initial_step(rhs, y, rhs(y, t0), rtol, 1e-6, t0)
    return bg, y, t0, h0, bound


@pytest.mark.parametrize("cap", [3, 500])
@pytest.mark.parametrize("instance", INSTANCES)
@pytest.mark.parametrize("kind", ["static", "time"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_interval_kernel_equals_plain(jet_field, dev, dtype, kind, instance,
                                      cap):
    """The interval kernel (``integrate_interval_rays`` on CUDA: one
    launch) against the plain loop over ``ray._rhs_core``, bitwise: y, t, h
    and each lane's trips, with NaN-entry lanes, lanes at and past their
    bounds, a cap that binds (3) and one that does not (500)."""
    bg, y, t0, h0, bound = interval_inputs(jet_field, kind, dtype, dev)
    rtol = rk45.validate_tol(1e-6, dtype)
    before = (rk45.INTERVAL_LAUNCHES, ray.LAUNCHES)
    k = rk45._integrate_interval_cuda(bg, y, t0, h0, bound, rtol, 1e-6, 7.2,
                                      max_iters=cap, instance=instance)
    assert (rk45.INTERVAL_LAUNCHES, ray.LAUNCHES) == (before[0] + 1,
                                                      before[1])
    p = rk45._integrate_interval_plain(bg, y, t0, h0, bound, rtol, 1e-6,
                                       7.2, max_iters=cap)
    for i in (0, 1, 2):
        assert same(k[i], p[i]), i
    assert torch.equal(k[5], p[5]) and int(k[3]) == p[3]
    att = k[5].cpu().numpy()
    if cap == 3:
        assert (att == 3).any() and (att < 3).any()
    elif dtype == torch.float64:
        assert att.max() < cap
    assert (att == 0).sum() >= 3   # NaN-entry and at-bound lanes


def test_interval_entry_chooses_and_refuses(jet_field, dev):
    """``integrate_interval_rays`` on CUDA takes the launcher's instance
    and equals the plain loop; it refuses a mixed-precision state and a
    non-contiguous one."""
    bg, y, t0, h0, bound = interval_inputs(jet_field, "static",
                                           torch.float32, dev)
    k = rk45.integrate_interval_rays(bg, y, t0, h0, bound, 1e-5, 1e-6, 7.2,
                                     max_iters=50)
    p = rk45._integrate_interval_plain(bg, y, t0, h0, bound, 1e-5, 1e-6, 7.2,
                                       max_iters=50)
    for i in (0, 1, 2):
        assert same(k[i], p[i]), i
    with pytest.raises(ValueError):
        rk45.integrate_interval_rays(bg, y.double(), t0.double(),
                                     h0.double(), bound.double(), 1e-5, 1e-6,
                                     7.2)
    with pytest.raises(ValueError):
        rk45.integrate_interval_rays(bg, y.t().contiguous().t(), t0, h0,
                                     bound, 1e-5, 1e-6, 7.2)


def flux_trajectories(dtype, dev, nt=40, shape=(3, 50, 7), seed=5):
    """Trajectories for the flux kernel, laid out as ``trace_rays`` leaves
    them (views of an (nt, 5, R) row stack): random walks, rays circling
    past the three longitude circles, dead tails, rootless lanes, a NaN
    row 0 and zero group velocity."""
    from rwrt_tpu_torch.tracer import RayTrajectories

    rng = np.random.default_rng(seed)
    r = int(np.prod(shape))
    step = rng.normal(0, 0.15, (1, r)) + rng.normal(0, 0.05, (nt, r))
    step[:, :40] = 0.6
    step[:, 40:80] = -0.5
    lon = np.cumsum(step, 0) + rng.uniform(0, 2 * np.pi, (1, r))
    lat = np.clip(np.cumsum(rng.normal(0, 0.05, (nt, r)), 0)
                  + rng.uniform(-1, 1, (1, r)), -1.5, 1.5)
    rows = np.stack([lon, lat, rng.uniform(1, 7, (nt, r)),
                     rng.normal(0, 80, (nt, r)), rng.normal(0, 2, (nt, r))],
                    1)
    ug, vg = rng.normal(0, 30, (nt, r)), rng.normal(0, 20, (nt, r))
    ug[:, 100:120] = vg[:, 100:120] = 0.0
    rows[nt * 2 // 3:, :, 200:260] = np.nan
    ug[nt * 2 // 3:, 200:260] = vg[nt * 2 // 3:, 200:260] = np.nan
    rows[:, 4, 300:350] = np.nan
    rows[0, 0, 400:420] = np.nan
    ys = torch.as_tensor(rows, dtype=dtype, device=dev)
    full = (nt, *shape)
    return RayTrajectories(*(ys[:, i].reshape(full) for i in range(5)),
                           torch.as_tensor(ug, dtype=dtype,
                                           device=dev).reshape(full),
                           torch.as_tensor(vg, dtype=dtype,
                                           device=dev).reshape(full))


#: The flux kernel's sums against the plain version's: the atomics add a
#: cell's points in an order that changes from run to run, so the maps
#: other than count are held to these fractions of each map's largest
#: magnitude (count, a sum of ones, and the carry are bitwise).
FLUX_BARS = {torch.float32: 1e-4, torch.float64: 1e-12}
FLUX_CASES = {
    "amp_cg": dict(),
    "count_fun1": dict(weight="count", speed_min=10.0, speed_max=40.0,
                       mwn_max=60.0),
    "cg_amp": dict(weight="cg", amp_min=0.5, amp_max=3.0),
    "dateline": dict(lon_range=(170.0, -160.0), lat_range=(-30.0, 40.0)),
    "circle": dict(weight="count", lon_range=(-180.0, 180.0),
                   lat_range=(20.0, 60.0)),
    "amp_cg_box_mwn": dict(lon_range=(100.0, 300.0), lat_range=(-40.0, 40.0),
                           mwn_max=60.0),
    "cg_box_speed": dict(weight="cg", speed_min=15.0,
                         lon_range=(0.0, 200.0), lat_range=(-60.0, 10.0)),
}


@pytest.mark.parametrize("case", list(FLUX_CASES))
@pytest.mark.parametrize("dtype", DTYPES)
def test_flux_kernel_equals_plain(dev, dtype, case):
    """``wave_ray_flux`` on the card: one binning launch (and one region
    pass with a box); the region mask and count map bitwise, the other maps
    within FLUX_BARS of the plain version; then a second block chained
    through the carry: the carry bitwise."""
    from rwrt_tpu_torch.diagnostics import flux

    traj = flux_trajectories(dtype, dev)
    kw = dict(FLUX_CASES[case], nlon_bins=72, nlat_bins=30)
    before = (flux.LAUNCHES, flux.REGION_LAUNCHES)
    k = flux.wave_ray_flux(traj, **kw)
    region = "lon_range" in kw
    assert (flux.LAUNCHES, flux.REGION_LAUNCHES) == (before[0] + 1,
                                                     before[1] + region)
    rows = [flux._rows(getattr(traj, n))
            for n in ("lon", "lat", "amp", "ug", "vg", "ky")]
    keep = None
    if region:
        zero = torch.zeros(rows[0].shape[1], dtype=torch.bool, device=dev)
        keep = flux._region_plain(*rows[:3], zero, kw["lon_range"],
                                  kw["lat_range"])
        assert torch.equal(flux.region_mask(traj, kw["lon_range"],
                                            kw["lat_range"]).reshape(-1),
                           keep)
    th = flux.Thresholds(**{a: kw[a] for a in flux.Thresholds._fields
                            if a in kw})
    weight = kw.get("weight", "amp_cg")
    p, _ = flux._accumulate_plain(*rows, keep, None, 72, 30, th, weight)
    for a, b in zip((k.flux_u, k.flux_v, k.amp_sum, k.count), p):
        assert a.dtype == dtype and same_nan(a, b)
        scale = float(torch.nan_to_num(b.abs(), nan=0.0).max())
        err = float(torch.nan_to_num((a - b).abs(), nan=0.0).max())
        assert err <= FLUX_BARS[dtype] * max(scale, 1e-300)
    assert torch.equal(k.count, p[3])
    carry = None
    for t0, t1 in ((0, 13), (13, 40)):
        block = [x[t0:t1] for x in rows]
        km, kc = flux._accumulate_cuda(*block, keep, carry, 72, 30, th,
                                       weight)
        pm, pc = flux._accumulate_plain(*block, keep, carry, 72, 30, th,
                                        weight)
        assert torch.equal(km[3], pm[3])
        for a, b in zip(kc, pc):
            assert same(a, b)
        carry = kc


def maps_within_bars(got, want, dtype):
    """Count bitwise, the other maps within FLUX_BARS of each map's max."""
    assert torch.equal(got[3], want[3])
    for a, b in zip(got[:3], want[:3]):
        assert a.dtype == b.dtype and same_nan(a, b)
        scale = float(torch.nan_to_num(b.abs(), nan=0.0).max())
        err = float(torch.nan_to_num((a - b).abs(), nan=0.0).max())
        assert err <= FLUX_BARS[dtype] * max(scale, 1e-300)


@pytest.mark.parametrize("block", [1, 7, 40])
@pytest.mark.parametrize("case", list(FLUX_CASES))
@pytest.mark.parametrize("dtype", DTYPES)
def test_flux_blocks_equal_plain(dev, dtype, case, block):
    """The binning kernel chained through its carry over time blocks of 1,
    7 and all 40 rows, each block against ``_accumulate_plain`` on the
    same carry: the maps within FLUX_BARS (count bitwise), the carry
    bitwise (NaN for the rays the region pass dropped)."""
    from rwrt_tpu_torch.diagnostics import flux

    traj = flux_trajectories(dtype, dev)
    kw = FLUX_CASES[case]
    rows = [flux._rows(getattr(traj, n))
            for n in ("lon", "lat", "amp", "ug", "vg", "ky")]
    keep = None
    if "lon_range" in kw:
        zero = torch.zeros(rows[0].shape[1], dtype=torch.bool, device=dev)
        keep = flux._region_plain(*rows[:3], zero, kw["lon_range"],
                                  kw["lat_range"])
        assert 0 < int(keep.sum()) < keep.numel()
    th = flux.Thresholds(**{a: kw[a] for a in flux.Thresholds._fields
                            if a in kw})
    weight = kw.get("weight", "amp_cg")
    carry = pcarry = None
    for t0 in range(0, 40, block):
        part = [x[t0:t0 + block] for x in rows]
        before = flux.LAUNCHES
        km, carry = flux._accumulate_cuda(*part, keep, carry, 72, 30, th,
                                          weight)
        assert flux.LAUNCHES == before + 1
        pm, pcarry = flux._accumulate_plain(*part, keep, pcarry, 72, 30, th,
                                            weight)
        maps_within_bars(km, pm, dtype)
        for a, b in zip(carry, pcarry):
            assert same(a, b)


def same_nan(a, b):
    return torch.equal(torch.isnan(a), torch.isnan(b))


@pytest.mark.parametrize("dtype", DTYPES)
def test_flux_chunked_on_the_card(dev, dtype):
    """``wave_ray_flux_chunked`` over a host history, one block copied to
    the card at a time: float64 maps, one binning launch per block and one
    region pass per block; the count equal to the one-shot count and the
    other maps within FLUX_BARS of the one-shot maps. Each block's unwrap
    restarts its running sum from the carry, so in float32 a point on a
    cell edge could move; on these trajectories none does (the plain
    versions, which bin as the kernel does, move none of the 29,548 binned
    points at time_block 1, 7 or 13 on the CPU)."""
    from rwrt_tpu_torch.diagnostics import flux

    traj = flux_trajectories(dtype, dev)
    host = type(traj)(*(x.cpu() for x in traj))
    kw = dict(nlon_bins=72, nlat_bins=30, lon_range=(100.0, 300.0),
              lat_range=(-40.0, 40.0))
    one = flux.wave_ray_flux(traj, **kw)
    for tb in (7, 40):
        before = (flux.LAUNCHES, flux.REGION_LAUNCHES)
        got = flux.wave_ray_flux_chunked(host, time_block=tb, **kw)
        n = -(-40 // tb)
        assert (flux.LAUNCHES, flux.REGION_LAUNCHES) == (before[0] + n,
                                                         before[1] + n)
        assert got.count.dtype == torch.float64 and got.count.is_cuda
        assert torch.equal(got.count, one.count.double())
        for a, b in zip(got[2:5], one[2:5]):
            b = b.double()
            scale = float(torch.nan_to_num(b.abs(), nan=0.0).max())
            err = float(torch.nan_to_num((a - b).abs(), nan=0.0).max())
            assert err <= FLUX_BARS[dtype] * max(scale, 1e-300)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(131072, 48), (131072, 128),
                                   (131072, 384), (1001, 48)],
                         ids=["w48", "w128", "w384", "ragged"])
def test_gather_kernel_equals_plain(dev, dtype, shape):
    """``gather_rows`` on the card (one launch) bitwise equal to
    ``index_select``, at the probe's widths and on a ragged row count."""
    from rwrt_tpu_torch.probes import gather_probe as gp

    r, width = shape
    rng = np.random.default_rng(3)
    table = torch.as_tensor(rng.normal(size=(gp.WH, width)), dtype=dtype,
                            device=dev)
    idx = torch.as_tensor(rng.integers(0, gp.WH, r).astype(np.int32),
                          device=dev)
    before = gp.LAUNCHES
    got = gp.gather_rows(table, idx)
    torch.cuda.synchronize()
    assert gp.LAUNCHES == before + 1
    assert torch.equal(got, gp.gather_rows_plain(table, idx))


def test_gather_kernel_refuses_what_it_cannot_take(dev):
    from rwrt_tpu_torch.probes import gather_probe as gp

    idx = torch.zeros(8, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="16-byte"):
        gp.gather_rows(torch.zeros((10, 6), device=dev), idx)
    with pytest.raises(ValueError, match="dtype"):
        gp.gather_rows(torch.zeros((10, 8), device=dev), idx.long())


def test_root_backward_on_the_card_equals_the_cpu(dev):
    """The roots' implicit-function gradient (``cubic._Roots``) on the card
    against the CPU's on the same coefficients: the same elementwise
    arithmetic, to 1e-12 of each coefficient's largest gradient."""
    from rwrt_tpu_torch.ops import cubic

    rng = np.random.default_rng(7)
    n = 4096
    fu = rng.normal(15.0, 12.0, n)
    fv = np.where(rng.random(n) < 0.25, 0.0, rng.normal(0.0, 4.0, n))
    fqx, fqy = rng.normal(0.0, 1.0, n), rng.normal(2.0, 1.0, n)
    g = rng.normal(size=(n, 3))
    grads = []
    for device in ("cpu", dev):
        args = [torch.tensor(a, dtype=torch.float64, device=device,
                             requires_grad=True) for a in (fu, fv, fqx, fqy)]
        zwn = torch.full((n,), 4.0, dtype=torch.float64, device=device)
        m, _ = cubic.solve_dispersion_cubic(*args, 0.0, zwn)
        gt = torch.where(torch.isnan(m), torch.zeros_like(m),
                         torch.as_tensor(g, device=device))
        grads.append([x.cpu() for x in torch.autograd.grad(m, args, gt)])
    for a, b in zip(*grads):
        assert torch.isfinite(b).all()
        assert float((a - b).abs().max()) <= 1e-12 * float(a.abs().max())


def test_gradient_through_prepare_and_rk4_on_the_card(jet_field, dev):
    """d(final lat)/d(wind amplitude) through prepare -> initialize ->
    24 RK4 steps (``solvers/rk4.trace``: plain ops, no kernel launch) on
    the card equals the CPU's to 1e-9 relative."""
    from rwrt_tpu_torch.diagnostics import flux
    from rwrt_tpu_torch.probes import gather_probe

    u, v, lat, lon = jet_field
    grads = []
    counters = (ray, "LAUNCHES"), (tracer, "RK4_LAUNCHES"), (
        tracer, "LAUNCHES"), (tracer, "EXACT_LAUNCHES"), (
        flux, "LAUNCHES"), (spec, "LAUNCHES"), (gather_probe, "LAUNCHES")
    before = [getattr(m, n) for m, n in counters]
    for device in ("cpu", dev):
        amp = torch.tensor(1.0, dtype=torch.float64, device=device,
                           requires_grad=True)
        bs = pt.prepare(amp * torch.as_tensor(u, device=device),
                        torch.as_tensor(v), lat, lon, read_dtype="float64",
                        cal_dtype="float64", device=device)
        bg = tracer.make_background(bs, 0.0)
        y0, _, _ = tracer.initialize(*(
            [bg] + [torch.tensor(x, dtype=torch.float64, device=device)
                    for x in ([0.3], [0.25], [4.0])]))
        ys, _, _ = rk4.trace(bg, y0, 7200.0, 25, 0.2)
        (g,) = torch.autograd.grad(ys[-1, 1, 0], amp)
        grads.append(float(g))
    assert [getattr(m, n) for m, n in counters] == before
    assert np.isfinite(grads[1])
    assert abs(grads[1] - grads[0]) <= 1e-9 * abs(grads[0])


def test_trace_rays_refuses_a_gradient_carrying_state(jet_field, dev):
    """A state prepared from a wind that requires grad reaches the kernel
    guard at ``trace_rays``' first launch and raises; it does not
    return."""
    u, v, lat, lon = jet_field
    ut = torch.as_tensor(u, device=dev).requires_grad_(True)
    bs = pt.prepare(ut, v, lat, lon, cal_dtype="float64", device=dev)
    cfg = pt.RunConfig(nnx=3, nny=3, ttotal=4 * 7200.0,
                       cal_dtype="float64")
    for c in (cfg, pt.RunConfig(nnx=3, nny=3, ttotal=4 * 7200.0,
                                integrator="rk45", cal_dtype="float64")):
        with pytest.raises(RuntimeError, match="differentiable route"):
            pt.trace_rays(bs, c)
    with torch.no_grad():
        traj = pt.trace_rays(bs, cfg)
    assert not traj.lat.requires_grad


# The whole-run dense kernel repacks live lanes into full warps inside the
# launch (csrc/dense_run.cu): blocks of a persistent grid, a lane queue
# where lanes outnumber the resident threads, the (ug, vg) post-pass over
# the block. Which thread runs a lane, and when, must change no bit.

#: Lane counts that cut the warp and block edges (blocks of 512 threads in
#: float32, 384 in its time instance, 256 with a float64 state).
REPACK_LANES = [1, 31, 33, 207, 383, 385, 511, 513, 4097]
#: The cases of the repacking tests: kills inside groups (cut_off 0.03)
#: under pin (500, 0); no pin, so stragglers run to the group's end; pin
#: at 8 attempts, so many lanes retire early among lanes that go on; a
#: max_iters backstop of 3 trips, so lanes are truncated.
REPACK_CASES = {
    "cutoff": dict(cut_off=0.03, pin_limit=500, pin_mwn=0.0),
    "nopin": dict(cut_off=0.2),
    "pin8": dict(cut_off=0.2, pin_limit=8, pin_mwn=0.0),
    "maxiters": dict(cut_off=0.2, pin_limit=500, pin_mwn=0.0, max_iters=3),
}
REPACK_KINDS = ["static"] + KINDS
_REPACK_RUNS = {}


def repack_inputs(jet_field, kind, key, dev):
    """The entry state of a 48 x 36 source grid from 70 S plus the three
    polar sources of ``dense_run_inputs``, zwn 2, 4, 6 (5,193 lanes, about
    a third rootless, so frozen at their seed state), in a fixed shuffled
    order with the 27 polar lanes at the odd positions 1..53, so that every
    prefix mixes polar, frozen and born lanes; over a static background or
    a ``kind`` one (member maps cycling lane by lane). Returns (args of
    ``_dense_run`` without the case's scalars, rtol)."""
    state, field = KEYS[key]
    _, bg0 = background(jet_field, field, dev)
    slon, slat = tracer.source_matrix(0.0, -70.0, 7.5, 4.0, 48, 36)
    slon = np.concatenate([slon, np.radians([10.0, 100.0, 200.0])])
    slat = np.concatenate([slat, np.radians([86.0, 88.5, -87.0])])
    y0, ug0, vg0 = tracer.initialize(
        bg0, torch.as_tensor(slon, dtype=field, device=dev),
        torch.as_tensor(slat, dtype=field, device=dev),
        torch.tensor([2.0, 4.0, 6.0], dtype=field, device=dev))
    n_src, r = slon.size, y0.shape[1]
    src = (np.arange(r) // 3) % n_src
    polar = np.flatnonzero(src >= n_src - 3)
    rest = np.random.default_rng(5).permutation(
        np.setdiff1d(np.arange(r), polar))
    order = list(rest)
    for j, p in enumerate(polar):
        order.insert(1 + 2 * j, p)
    take = torch.as_tensor(np.array(order), device=dev)
    y0, ug0, vg0 = (x.index_select(-1, take).contiguous()
                    for x in (y0.to(state), ug0, vg0))
    bg = bg0 if kind == "static" else varying_background(
        jet_field, kind, field, dev, r)
    rtol = rk45.validate_tol(1e-6, state)
    h0 = tracer.initial_step_sizes(bg, y0, rtol, 1e-6)
    f0 = ray.RayRHS(bg)(y0)
    bounds_g = tracer.padded_bounds(7200.0, 13, 5, state, dev)
    return (bg, y0, ug0, vg0, h0, f0, bounds_g, 12), rtol


def first_lanes(args, n):
    """``_dense_run``'s arguments cut to their first n lanes (and an
    ensemble's member map with them)."""
    bg, r = args[0], args[1].shape[1]
    if bg.member_ids is not None:
        bg = bg._replace(member_ids=bg.member_ids[:n].contiguous())
    return (bg,) + tuple(
        x[..., :n].contiguous() if torch.is_tensor(x) and x.ndim
        and x.shape[-1] == r else x for x in args[1:])


def repack_case(jet_field, dev, key, kind, case):
    """(the case's full-width arguments, its keyword arguments, the plain
    run on every lane), made once per (key, kind, case): lanes are
    independent, so the plain run's first n lanes are the plain run of
    the first n lanes."""
    tag = (key, kind, case)
    if tag not in _REPACK_RUNS:
        (bg, y0, ug0, vg0, h0, f0, bounds_g, n_bounds), rtol = (
            repack_inputs(jet_field, kind, key, dev))
        kw = dict(REPACK_CASES[case])
        args = (bg, y0, ug0, vg0, h0, f0, bounds_g, n_bounds,
                kw.pop("cut_off"), rtol, 1e-6, 7.2)
        _REPACK_RUNS[tag] = (args, kw, tracer._dense_run_plain(*args, **kw))
    return _REPACK_RUNS[tag]


def equal_to_plain(k, p, n):
    """A kernel run over the first n lanes against the plain run of every
    lane: rows, ug, vg, attempts, truncation counts and carry, bitwise."""
    for a, b in zip(k[:3] + k.carry, p[:3] + p.carry):
        assert a.dtype == b.dtype and same(a, b[..., :n])
    assert torch.equal(k.lane_att, p.lane_att[:, :n])
    assert torch.equal(k.trunc, p.trunc[:n])


def dense_cuda(args, kw, **private):
    """``tracer._dense_run_cuda`` with ``_dense_run``'s defaults."""
    full = dict(max_iters=1_000_000, pin_limit=None, pin_mwn=None)
    full.update(kw)
    return tracer._dense_run_cuda(*args, full["max_iters"],
                                  full["pin_limit"], full["pin_mwn"],
                                  **private)


@pytest.mark.parametrize("n", REPACK_LANES)
@pytest.mark.parametrize("kind", REPACK_KINDS)
@pytest.mark.parametrize("key", list(KEYS))
def test_dense_run_repacking_lane_counts(jet_field, dev, key, kind, n):
    """The repacking kernel over the first n lanes (frozen, polar, killed
    and pinned lanes among them), one launch on the default grid, against
    the plain run bitwise."""
    args, kw, p = repack_case(jet_field, dev, key, kind, "cutoff")
    before = tracer.LAUNCHES
    k = tracer._dense_run(*first_lanes(args, n), **kw)
    assert tracer.LAUNCHES == before + 1
    equal_to_plain(k, p, n)
    if n == 4097:
        assert (torch.isnan(k.ys[-1, 0]) & ~torch.isnan(k.ys[0, 3])).any()
        assert torch.isnan(k.ys[0, 3]).any()


@pytest.mark.parametrize("n", [513, 4097])
@pytest.mark.parametrize("case", ["nopin", "pin8", "maxiters"])
@pytest.mark.parametrize("kind", REPACK_KINDS)
@pytest.mark.parametrize("key", list(KEYS))
def test_dense_run_repacking_stragglers(jet_field, dev, key, kind, case, n):
    """Stragglers among easy lanes: no pin, an early pin that retires many
    lanes while others go on, and the max_iters backstop truncating lanes;
    bitwise against the plain run."""
    args, kw, p = repack_case(jet_field, dev, key, kind, case)
    k = tracer._dense_run(*first_lanes(args, n), **kw)
    equal_to_plain(k, p, n)
    if case == "maxiters":
        assert int(k.trunc.sum()) > 0


#: Repack schedules (most iterations a window, lanes whose leaving ends
#: it; None: no early end): every iteration, every 3, windows ended by the
#: first lane to leave or by a warp's worth, windows longer than any lane.
SCHEDULES = [(1, None), (3, None), (8, 1), (64, 7), (1000, 32), (1000, None)]


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("blocks", [1, 3])
@pytest.mark.parametrize("kind", REPACK_KINDS)
@pytest.mark.parametrize("key", list(KEYS))
def test_dense_run_repacking_queue_refills(jet_field, dev, key, kind, blocks,
                                           schedule):
    """More lanes than resident threads: a grid of 1 or 3 blocks over
    4,097 lanes takes the rest from the queue as lanes leave, under each
    repack schedule; bitwise against the plain run."""
    args, kw, p = repack_case(jet_field, dev, key, kind, "cutoff")
    sub = first_lanes(args, 4097)
    every, trigger = schedule
    before = tracer.LAUNCHES
    k = dense_cuda(sub, kw, _blocks=blocks, _repack=every,
                   _trigger=trigger or 1 << 30)
    assert tracer.LAUNCHES == before + 1
    equal_to_plain(k, p, 4097)


def test_dense_run_grid_and_private_arguments(jet_field, dev):
    """The default grid is the resident blocks of the instance, at least
    one a SM, 512 threads in float32 (384 in its time instance) and 256
    with a float64 state; the private arguments refuse values below 1."""
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    for key, threads in ((KEYS["float32"], (512, 384)),
                         (KEYS["float64"], (256, 256)),
                         (KEYS["mixed"], (256, 256))):
        for variant, want in zip(("", "_time"), threads):
            blocks, block = tracer.dense_grid(key, variant)
            assert block == want and blocks >= n_sm
    args, kw, _ = repack_case(jet_field, dev, "float32", "static", "cutoff")
    for bad in (dict(_blocks=0), dict(_repack=0), dict(_trigger=0)):
        with pytest.raises(ValueError):
            dense_cuda(first_lanes(args, 33), kw, **bad)


# ---- The adaptive runs' entry stage (csrc/entry.cu) ----

ENTRY_KINDS = ["static", "time", "member", "member_time"]


def entry_case(jet_field, dev, key, kind, states):
    """(bg, y0, t0) for the entry kernel: the 207-lane entry state of
    ``dense_run_inputs`` (72 rootless lanes: NaN ky and amp), or 5,000
    seeded states (|lat| past pi/2, the polar cap, |ky| >= 100, NaN lon,
    ky and amp), in the state's dtype; per-lane times over and past the
    frames of the time backgrounds."""
    state, field = KEYS[key]
    if states == "entry":
        _, bg0 = background(jet_field, field, dev)
        (y0, *_), _ = dense_run_inputs(bg0, field, dev, state=state)
    else:
        y0 = seeded_states(state, dev)
    r = y0.shape[1]
    bg = (background(jet_field, field, dev)[1] if kind == "static"
          else varying_background(jet_field, kind, field, dev, r))
    rng = np.random.default_rng(17)
    t0 = torch.as_tensor(rng.uniform(-0.5 * DAY, 1.5 * DAY, r), dtype=state,
                         device=dev)
    return bg, y0, t0


@pytest.mark.parametrize("states", ["entry", "seeded"])
@pytest.mark.parametrize("kind", ENTRY_KINDS)
@pytest.mark.parametrize("key", list(KEYS))
def test_entry_kernel_equals_plain(jet_field, dev, key, kind, states):
    """``tracer.entry_stage`` on the card (one launch of the entry kernel,
    no RHS launch) against its plain route on the card, bitwise: h0 and f0
    in float32, float64 and mixed, static and time instances (daily
    frames, members, time-varying members), at t0 = 0 and at per-lane
    times."""
    bg, y0, t0 = entry_case(jet_field, dev, key, kind, states)
    rtol = rk45.validate_tol(1e-6, y0.dtype)
    for t in (0.0, t0):
        before = (tracer.ENTRY_LAUNCHES, ray.LAUNCHES)
        h, f = tracer.entry_stage(bg, y0, t, rtol, 1e-6)
        assert (tracer.ENTRY_LAUNCHES, ray.LAUNCHES) == (before[0] + 1,
                                                         before[1])
        ph, pf = tracer._entry_stage_plain(bg, y0, t, rtol, 1e-6)
        assert h.dtype == y0.dtype and f.dtype == bg.fields.dtype
        assert same(h, ph) and same(f, pf)
        assert bool(torch.isfinite(h).any())


def test_entry_stage_refuses_bad_inputs(jet_field, dev):
    """The entry kernel's wrapper: a (4, R) state, a float32 state over
    float64 fields, a per-lane time of another dtype or length, a member
    map of another length, and a gradient-carrying state all raise."""
    _, bg = background(jet_field, torch.float32, dev)
    y = seeded_states(torch.float32, dev, n=64)
    with pytest.raises(ValueError):
        tracer.entry_stage(bg, y[:4], 0.0, 1e-5, 1e-6)
    _, bg64 = background(jet_field, torch.float64, dev)
    with pytest.raises(ValueError):
        tracer.entry_stage(bg64, y, 0.0, 1e-5, 1e-6)
    tv = varying_background(jet_field, "time", torch.float32, dev)
    for t in (torch.zeros(64, dtype=torch.float64, device=dev),
              torch.zeros(63, device=dev)):
        with pytest.raises(ValueError):
            tracer.entry_stage(tv, y, t, 1e-5, 1e-6)
    members = varying_background(jet_field, "member", torch.float32, dev, 63)
    with pytest.raises(ValueError):
        tracer.entry_stage(members, y, 0.0, 1e-5, 1e-6)
    with pytest.raises(RuntimeError):
        tracer.entry_stage(bg, y.clone().requires_grad_(), 0.0, 1e-5, 1e-6)
    # A non-contiguous state is taken as its contiguous copy.
    k = tracer.entry_stage(bg, y.t().contiguous().t(), 0.0, 1e-5, 1e-6)
    p = tracer._entry_stage_plain(bg, y, 0.0, 1e-5, 1e-6)
    assert same(k[0], p[0]) and same(k[1], p[1])


@pytest.mark.parametrize("kind", ["static", "time"])
def test_chunked_resume_makes_one_entry_launch(jet_field, dev, kind,
                                               tmp_path):
    """The chunked driver's start and its resume from a checkpoint each
    make one entry-stage launch and no RHS launch; the resumed rows are
    the uninterrupted run's, bitwise."""
    from rwrt_tpu_torch.utils import checkpoint

    if kind == "time":
        fu, fv, lat, lon = frames(jet_field)
        bs = pt.prepare_time_varying(fu, fv, lat, lon, bg_t0=-0.3 * DAY,
                                     bg_dt=0.2 * DAY, cal_dtype="float32",
                                     device=dev)
    else:
        bs, _ = background(jet_field, torch.float32, dev)
    cfg = pt.RunConfig(zwn=(2.0, 4.0, 6.0), sw_lon=0.0, sw_lat=5.0,
                       dlon=36.0, dlat=8.0, nnx=5, nny=4, tstep=7200.0,
                       ttotal=2 * DAY, integrator="rk45", bound_mode="dense",
                       interval_batch=8, compact_dead=False)
    want = checkpoint.trace_rays_chunked(bs, cfg, chunk_steps=8,
                                         verbose=False)
    path = str(tmp_path / "ck.npz")
    counts = []
    for _ in range(2):
        before = (tracer.ENTRY_LAUNCHES, ray.LAUNCHES)
        try:
            got = checkpoint.trace_rays_chunked(
                bs, cfg, chunk_steps=8, checkpoint_path=path, max_chunks=2,
                verbose=False)
        except checkpoint.ChunkBudgetReached:
            got = None
        counts.append((tracer.ENTRY_LAUNCHES - before[0],
                       ray.LAUNCHES - before[1]))
    assert counts == [(1, 0), (1, 0)]
    for name in want._fields:
        assert same(getattr(want, name), getattr(got, name)), name


@pytest.mark.parametrize("kind", ["static", "time"])
def test_chunked_resume_without_saved_h(jet_field, dev, kind, tmp_path):
    """A resume from a checkpoint that holds no step size takes h at
    t = 0: one entry-stage launch over a static background (the launch at
    the lanes' times gives that h), two over a time-varying one (the
    second at t = 0); no RHS launch. The rows the checkpoint holds are the
    uninterrupted run's, bitwise, and every ray alive there runs on."""
    from rwrt_tpu_torch.utils import checkpoint

    if kind == "time":
        fu, fv, lat, lon = frames(jet_field)
        bs = pt.prepare_time_varying(fu, fv, lat, lon, bg_t0=-0.3 * DAY,
                                     bg_dt=0.2 * DAY, cal_dtype="float32",
                                     device=dev)
    else:
        bs, _ = background(jet_field, torch.float32, dev)
    cfg = pt.RunConfig(zwn=(2.0, 4.0, 6.0), sw_lon=0.0, sw_lat=5.0,
                       dlon=36.0, dlat=8.0, nnx=5, nny=4, tstep=7200.0,
                       ttotal=2 * DAY, integrator="rk45", bound_mode="dense",
                       interval_batch=8, compact_dead=False)
    want = checkpoint.trace_rays_chunked(bs, cfg, chunk_steps=8,
                                         verbose=False)
    path = str(tmp_path / "ck.npz")
    with pytest.raises(checkpoint.ChunkBudgetReached):
        checkpoint.trace_rays_chunked(bs, cfg, chunk_steps=8,
                                      checkpoint_path=path, max_chunks=2,
                                      verbose=False)
    with np.load(path) as ds:
        saved = dict(ds)
    step = int(saved["step"])
    saved["h"] = np.array(0.0)  # a checkpoint without a step size
    np.savez_compressed(path, **saved)
    before = (tracer.ENTRY_LAUNCHES, ray.LAUNCHES)
    got = checkpoint.trace_rays_chunked(bs, cfg, chunk_steps=8,
                                        checkpoint_path=path, max_chunks=2,
                                        verbose=False)
    assert (tracer.ENTRY_LAUNCHES - before[0], ray.LAUNCHES - before[1]) \
        == ((2 if kind == "time" else 1), 0)
    for name in want._fields:
        assert same(getattr(want, name)[:step], getattr(got, name)[:step]), \
            name
    alive = (torch.isfinite(want.lon[step - 1])
             & torch.isfinite(want.ky[step - 1]))
    assert bool(torch.isfinite(got.lon[-1][alive]).any())


# ---- The flux region pass in row tiles (csrc/flux.cu region_kernel) ----

REGION_BOXES = {"circle": ((-180.0, 180.0), (20.0, 60.0)),
                "plain": ((150.0, 240.0), (20.0, 60.0)),
                "dateline": ((170.0, -160.0), (-30.0, 40.0))}


def region_case(nt, r, box, dtype, dev, seed=9):
    """(nt, r) lon, lat, amp rows laid out as ``trace_rays`` leaves them
    (views of an (nt, 5, r) stack: a row stride of 5 r), random walks, and
    rays placed by hand: ray 0's only live in-box point is its last row,
    ray 1's only in-box row has a NaN amp, ray 2 enters at row 0 only, the
    rays from r - 40 on enter at their last row only, one ray is dead from
    row 1; and a ``keep`` holding every 7th ray, as an earlier block of
    the chunked path leaves it."""
    rng = np.random.default_rng(seed)
    lon = np.cumsum(rng.normal(0, 0.1, (nt, r)), 0) + rng.uniform(
        0, 2 * np.pi, (1, r))
    lat = np.clip(np.cumsum(rng.normal(0, 0.05, (nt, r)), 0)
                  + rng.uniform(-1.2, 1.2, (1, r)), -1.5, 1.5)
    amp = rng.normal(0, 2, (nt, r))
    (lo0, _), (la0, la1) = box
    inside = np.radians([lo0 + 1.0, 0.5 * (la0 + la1)])
    outside = np.radians([lo0 - 5.0, la1 + 10.0])
    tail = list(range(max(r - 40, 4), r))
    hand = list(range(min(r, 4))) + tail
    lon[:, hand], lat[:, hand] = outside
    for ray, row in ((0, -1), (1, nt // 2), (2, 0)):
        if ray < r:
            lon[row, ray], lat[row, ray] = inside
    if r > 1:
        amp[nt // 2, 1] = np.nan
    if r > 3:
        lon[1:, 3] = lat[1:, 3] = amp[1:, 3] = np.nan
    lon[-1, tail], lat[-1, tail] = inside
    stack = np.zeros((nt, 5, r))
    stack[:, 0], stack[:, 1], stack[:, 4] = lon, lat, amp
    ys = torch.as_tensor(stack, dtype=dtype, device=dev)
    keep = torch.zeros(r, dtype=torch.bool, device=dev)
    keep[::7] = True
    return ys[:, 0], ys[:, 1], ys[:, 4], keep


@pytest.mark.parametrize("r", [1, 45, 1000])
@pytest.mark.parametrize("nt", [1, 65, 361])
@pytest.mark.parametrize("mode", list(REGION_BOXES))
@pytest.mark.parametrize("dtype", DTYPES)
def test_region_kernel_equals_plain(dev, dtype, mode, nt, r):
    """The region kernel (one launch) against ``_region_plain``, bitwise,
    with and without a carried ``keep``, over rows with a row stride of
    5 R, at 1, 65 (a tile and a row) and 361 rows, and at ray counts that
    are not a multiple of the 32 rays a block; the input ``keep`` is not
    written."""
    from rwrt_tpu_torch.diagnostics import flux

    box = REGION_BOXES[mode]
    lon, lat, amp, carried = region_case(nt, r, box, dtype, dev)
    assert lon.stride(0) == 5 * r
    for keep in (torch.zeros_like(carried), carried):
        held = keep.clone()
        before = flux.REGION_LAUNCHES
        k = flux._region_cuda(lon, lat, amp, keep, *box)
        assert flux.REGION_LAUNCHES == before + 1
        assert torch.equal(keep, held)
        p = flux._region_plain(lon, lat, amp, keep, *box)
        assert torch.equal(k, p)
    if nt > 1 and r > 40:
        assert bool(p[0]) and not bool(p[1]) and bool(p[r - 1])


def test_region_wrapper_refuses_bad_inputs(dev):
    """``_region_cuda`` refuses rows of another shape, dtype or device
    than lon's, and a keep of another shape or dtype."""
    from rwrt_tpu_torch.diagnostics import flux

    box = REGION_BOXES["plain"]
    lon, lat, amp, keep = region_case(5, 64, box, torch.float32, dev)
    for bad in ((lon, lat[:, :63], amp, keep), (lon, lat.double(), amp, keep),
                (lon, lat, amp.cpu(), keep), (lon, lat, amp, keep[:63]),
                (lon, lat, amp, keep.int())):
        with pytest.raises(ValueError):
            flux._region_cuda(*bad, *box)


# ---- The device mesh: one launch per shard, bitwise the meshless run ----

MESH_BRANCHES = {
    "rk4": dict(integrator="rk4"),
    "exact": dict(integrator="rk45", interval_batch=16),
    "exact_batch1": dict(integrator="rk45", interval_batch=1),
    "dense_pin": dict(integrator="rk45", bound_mode="dense",
                      interval_batch=16, pin_limit=500, pin_mwn=0.0),
}
MESH_CFG = dict(zwn=(2.0, 4.0, 6.0), sw_lon=0.0, sw_lat=5.0, dlon=36.0,
                dlat=8.0, nnx=5, nny=4, tstep=7200.0, ttotal=4 * DAY)


def card_mesh(dev, n=3):
    """A mesh of ``n`` entries that all name ``dev``: the 128 compacted
    lanes of MESH_CFG split 43 + 43 + 43 (one NaN pad lane)."""
    from rwrt_tpu_torch.parallel.sharding import Mesh

    return Mesh((dev,) * n)


def run_counts():
    return {"dense_run": tracer.LAUNCHES, "rk4_run": tracer.RK4_LAUNCHES,
            "exact_run": tracer.EXACT_LAUNCHES, "entry": tracer.ENTRY_LAUNCHES,
            "rhs": ray.LAUNCHES, "dense_group": rk45.LAUNCHES,
            "exact_group": rk45.EXACT_LAUNCHES}


def counted(fn):
    """fn()'s result and the launches it made, by kernel."""
    before = run_counts()
    out = fn()
    after = run_counts()
    return out, {k: after[k] - before[k] for k in after if after[k] != before[k]}


def traj_same(a, b):
    return all(getattr(a, k).dtype == getattr(b, k).dtype
               and getattr(a, k).device == getattr(b, k).device
               and same(getattr(a, k), getattr(b, k)) for k in a._fields)


def mesh_launches(branch, n):
    """The launches of a run over an n-shard mesh: one whole-run launch per
    shard, and an adaptive run's entry stage once per shard."""
    if branch == "rk4":
        return {"rk4_run": n}
    return {"dense_run" if branch == "dense_pin" else "exact_run": n,
            "entry": n}


@pytest.mark.parametrize("state", ["float32", "float64", "mixed"])
@pytest.mark.parametrize("branch", list(MESH_BRANCHES))
def test_mesh_run_bitwise_one_launch_per_shard(jet_field, dev, branch,
                                               state):
    """``trace_rays`` over a 3-entry mesh of one card: one launch per shard
    (the shards take the instance their lane count picks), rows, (ug, vg),
    attempts and truncation bitwise the run's without the mesh, on the
    state's device; the per-shard attempts are each shard's."""
    u, v, lat, lon = jet_field
    cal = "float64" if state == "float64" else "float32"
    bs = pt.prepare(u, v, lat, lon, cal_dtype=cal, device=dev)
    cfg = pt.RunConfig(**MESH_CFG, **MESH_BRANCHES[branch], cal_dtype=cal,
                       state_dtype="float64" if state == "mixed"
                       else "compute")
    s0, s3 = {}, {}
    want = pt.trace_rays(bs, cfg, stats=s0)
    got, launches = counted(lambda: pt.trace_rays(
        bs, cfg, mesh=card_mesh(dev), stats=s3))
    assert launches == mesh_launches(branch, 3)
    assert traj_same(want, got) and got.lon.is_cuda
    if branch != "rk4":
        assert torch.equal(s0["lane_att"], s3["lane_att"])
        att = torch.nn.functional.pad(s0["lane_att"], (0, 1))
        per_shard = att.reshape(att.shape[0], 3, -1).amax(dim=2).T
        assert torch.equal(s3["shard_iters"], per_shard)


@pytest.mark.parametrize("kind", ["time", "member"])
def test_mesh_time_and_ensemble_bitwise(jet_field, dev, kind):
    """A time-varying background, and an ensemble of two members (the
    member map split with the lanes, pad lanes member 0), over a 3-entry
    mesh in dense mode with pin: one launch per shard of the time
    instance, bitwise the meshless run."""
    u, v, lat, lon = jet_field
    cfg = pt.RunConfig(**MESH_CFG, **MESH_BRANCHES["dense_pin"])
    if kind == "time":
        fu, fv, _, _ = frames(jet_field)
        bs = pt.prepare_time_varying(fu, fv, lat, lon, bg_t0=-0.3 * DAY,
                                     bg_dt=DAY, device=dev)
        want = pt.trace_rays(bs, cfg)
        got, launches = counted(lambda: pt.trace_rays(
            bs, cfg, mesh=card_mesh(dev)))
        pairs = [(want, got)]
    else:
        members = [pt.prepare(s * u, v, lat, lon, device=dev)
                   for s in (0.9, 1.1)]
        want = pt.trace_rays_ensemble(members, cfg)
        got, launches = counted(lambda: pt.trace_rays_ensemble(
            members, cfg, mesh=card_mesh(dev)))
        pairs = list(zip(want, got))
    assert launches == {"dense_run": 3, "entry": 3}
    assert all(traj_same(a, b) for a, b in pairs)


@pytest.mark.parametrize("state", ["compute", "float64"],
                         ids=["float32", "mixed"])
def test_mesh_chunked_resume_bitwise(jet_field, dev, tmp_path, state):
    """The chunked driver over a 3-entry mesh: one dense launch per shard
    per chunk, bitwise the meshless chunked run; cut by a chunk budget with
    a checkpoint and resumed under the same mesh, bitwise; resumed under a
    4-entry mesh, refused."""
    from rwrt_tpu_torch.utils import checkpoint

    u, v, lat, lon = jet_field
    bs = pt.prepare(u, v, lat, lon, cal_dtype="float32", device=dev)
    cfg = pt.RunConfig(**MESH_CFG, **MESH_BRANCHES["dense_pin"],
                       state_dtype=state)
    kw = dict(chunk_steps=16, verbose=False, compact_min_width=8)
    want = checkpoint.trace_rays_chunked(bs, cfg, **kw)
    got, launches = counted(lambda: checkpoint.trace_rays_chunked(
        bs, cfg, mesh=card_mesh(dev), **kw))
    assert launches == {"dense_run": 9, "entry": 3}
    assert traj_same(want, got)
    path = str(tmp_path / "ck.npz")
    with pytest.raises(checkpoint.ChunkBudgetReached):
        checkpoint.trace_rays_chunked(bs, cfg, mesh=card_mesh(dev),
                                      checkpoint_path=path, max_chunks=1,
                                      **kw)
    with pytest.raises(ValueError, match="mesh"):
        checkpoint.trace_rays_chunked(bs, cfg, mesh=card_mesh(dev, 4),
                                      checkpoint_path=path, **kw)
    assert traj_same(want, checkpoint.trace_rays_chunked(
        bs, cfg, mesh=card_mesh(dev), checkpoint_path=path, **kw))


def test_mesh_wavenumber_maps_bitwise(jet_field, dev):
    """The wavenumber maps over a 3-entry mesh: bitwise the meshless maps
    (72 x 37 = 2,664 points: 888 a shard)."""
    from rwrt_tpu_torch.diagnostics import wavenumber

    u, v, lat, lon = jet_field
    bs = pt.prepare(u, v, lat, lon, device=dev)
    want = wavenumber.compute_wavenumber_maps(bs, (2.0, 4.0))
    got = wavenumber.compute_wavenumber_maps(bs, (2.0, 4.0),
                                             mesh=card_mesh(dev))
    assert all(same(getattr(want, k), getattr(got, k)) for k in want._fields)


def test_mesh_over_two_cards(jet_field, dev):
    """A mesh over two real cards: each shard's launches go to its own card
    (the occupancy counts read per card), the rows gathered on the state's
    card bitwise the meshless run's, for dense and RK4 runs."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    from rwrt_tpu_torch.parallel import sharding

    u, v, lat, lon = jet_field
    bs = pt.prepare(u, v, lat, lon, cal_dtype="float32", device=dev)
    mesh = sharding.make_mesh(2)
    assert mesh.devices == (torch.device("cuda", 0), torch.device("cuda", 1))
    for branch in ("dense_pin", "rk4"):
        cfg = pt.RunConfig(**MESH_CFG, **MESH_BRANCHES[branch])
        want = pt.trace_rays(bs, cfg)
        got, launches = counted(lambda: pt.trace_rays(bs, cfg, mesh=mesh))
        assert launches == mesh_launches(branch, 2)
        assert traj_same(want, got) and got.lon.device == dev
    key = (torch.float32, torch.float32)
    for i in range(2):
        with torch.cuda.device(i):
            assert tracer.dense_grid(key) == tracer._dense_grid(i, key, "")
