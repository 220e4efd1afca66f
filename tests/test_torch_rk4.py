"""Port parity: fixed-step RK4 (``solvers/rk4.py``, ``tracer._run_rk4``,
``tracer._rk4_chunk`` and ``trace_rays``' rk4 branch).

On a CPU state the plain versions run; the CUDA kernel (``csrc/rk4_run.cu``)
is held to them bitwise on the card (tests/test_torch_cuda_kernels.py).

The batch: the ``jet_field`` background carried across with ``convert``, a
5 x 4 source grid, zwn 2, 4, 6: 180 lanes, 54 of them rootless, float64.

Bars. RK4 has no controller to amplify an ulp, so the port stays within
round-off of the JAX package: the largest difference measured is 2.0e-16
of each row's scale after one step and 2.8e-14 after 10 days (120 steps);
the bars are 10x those, 3e-15 and 3e-13, with NaN masks identical at every
step.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import rwrt_tpu as rt
from rwrt_tpu import tracer as jtracer
from rwrt_tpu.models import ray as jray
from rwrt_tpu.solvers import rk4 as jrk4
import rwrt_tpu_torch as pt
from rwrt_tpu_torch import convert
from rwrt_tpu_torch import tracer as ttracer
from rwrt_tpu_torch.models import ray as tray
from rwrt_tpu_torch.solvers import rk4 as trk4

DT = 7200.0
CUT_OFF = 0.2
STEP_BAR = 3e-15
TEN_DAY_BAR = 3e-13


@pytest.fixture(scope="module")
def batch(jet_field):
    u, v, lat, lon = jet_field
    bsj = rt.prepare(u, v, lat, lon, cal_dtype="float64")
    bgj = jtracer.make_background(bsj, 0.0)
    bgt = convert.background_from_numpy(
        {k: np.asarray(x) for k, x in bgj._asdict().items() if x is not None},
        device="cpu")
    slon, slat = jtracer.source_matrix(0.0, 5.0, 36.0, 8.0, 5, 4)
    seeds = tuple(np.array(x) for x in jtracer.initialize(
        bgj, jnp.asarray(slon), jnp.asarray(slat),
        jnp.asarray([2.0, 4.0, 6.0])))
    return bsj, bgj, bgt, seeds


def same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return (np.array_equal(np.isnan(a), np.isnan(b))
            and np.array_equal(np.nan_to_num(a), np.nan_to_num(b)))


def assert_close(ref, out, bar):
    """NaN masks identical; |a - b| within ``bar`` of each row's scale
    (state rows: over steps and lanes; ug, vg: over everything)."""
    for a, b in zip(ref, out):
        a, b = np.asarray(a), np.asarray(b)
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        axes = (0, 2) if a.ndim == 3 else None
        scale = np.nanmax(np.abs(a), axis=axes, keepdims=a.ndim == 3)
        d = np.nan_to_num(np.abs(a - b)) / scale
        assert d.max() <= bar, d.max()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_step_factors_round_like_jax(dtype):
    np_dtype = np.dtype(str(dtype)[6:])
    for dt in (7200.0, 3600.0 * 7, 1e-3 / 3):
        d = jnp.asarray(dt, np_dtype)
        want = [float(d), float(0.5 * d), float(d / 6.0)]
        assert list(trk4.step_factors(dt, dtype)) == want


def test_rk4_step_matches_jax(batch):
    _, bgj, bgt, (y0, _, _) = batch
    ref = jrk4.rk4_step(bgj, jnp.asarray(y0), jnp.asarray(DT))
    out = trk4.rk4_step(bgt, torch.as_tensor(y0), DT)
    assert_close([ref], [out.numpy()], STEP_BAR)


def test_failed_stage_freezes_the_lane(batch):
    """A lane whose stages raise the fail flag (|ky| >= 100, or |lat| >=
    pi/2) keeps its state; a NaN state raises none and writes its NaN
    proposal."""
    _, bgj, bgt, (y0, _, _) = batch
    y = np.array(y0[:, np.flatnonzero(np.isfinite(y0[3]))[:4]])
    y[3, 0] = 150.0
    y[1, 1] = np.pi / 2
    y[3, 3] = np.nan
    ref = np.asarray(jrk4.rk4_step(bgj, jnp.asarray(y), jnp.asarray(DT)))
    out = trk4.rk4_step(bgt, torch.as_tensor(y), DT).numpy()
    assert same(ref, out)
    np.testing.assert_array_equal(out[:, :2], y[:, :2])
    assert np.isfinite(out[:, 2]).all() and (out[:, 2] != y[:, 2]).any()
    assert np.isnan(out[:, 3]).all()


def test_trace_matches_jax_over_ten_days(batch):
    _, bgj, bgt, (y0, ug0, vg0) = batch
    nt = 121
    ref = jrk4.trace(bgj, jnp.asarray(y0), jnp.asarray(DT), nt,
                     jnp.asarray(CUT_OFF), jnp.asarray(ug0), jnp.asarray(vg0))
    out = trk4.trace(bgt, torch.as_tensor(y0), DT, nt, CUT_OFF,
                     torch.as_tensor(ug0), torch.as_tensor(vg0))
    assert_close(ref, [x.numpy() for x in out], TEN_DAY_BAR)
    ys = out[0].numpy()
    born = np.isfinite(y0[3])
    # Rootless lanes are NaN from step 1; most born lanes live 10 days.
    assert np.isnan(ys[1:, :, ~born]).all()
    assert np.isfinite(ys[-1, 0, born]).mean() > 0.5


def test_trace_zero_invalid_row_zero(batch):
    """Without ug0, vg0, row 0 takes the zero-invalid group velocity, as
    the JAX package's trace does."""
    _, bgj, bgt, (y0, _, _) = batch
    ref = jrk4.trace(bgj, jnp.asarray(y0), jnp.asarray(DT), 3,
                     jnp.asarray(CUT_OFF))
    out = trk4.trace(bgt, torch.as_tensor(y0), DT, 3, CUT_OFF)
    assert_close(ref, [x.numpy() for x in out], STEP_BAR)


def test_chunks_equal_the_whole_run_bitwise(batch):
    """``_rk4_chunk`` in pieces of 5, 1 and 6 steps, carry passed on, gives
    ``_run_rk4``'s rows (the chunked driver's unit)."""
    _, _, bgt, seeds = batch
    y0, ug0, vg0 = (torch.as_tensor(x) for x in seeds)
    whole = ttracer._run_rk4(bgt, y0, ug0, vg0, DT, 13, CUT_OFF)
    y, rows = y0, [[y0[None]], [ug0[None]], [vg0[None]]]
    for n in (5, 1, 6):
        y, part = ttracer._rk4_chunk(bgt, y, DT, n, CUT_OFF)
        for acc, p in zip(rows, part):
            acc.append(p)
    for a, b in zip(whole, rows):
        assert same(a, torch.cat(b))
    assert same(y, whole[0][-1])


def test_fourth_order_convergence(jet_field):
    """Halving dt cuts the port's RK4 trajectory error ~16x against its
    own tight exact-mode RK45 (the JAX package's
    test_rk4_fourth_order_convergence)."""
    u, v, lat, lon = jet_field
    bs = pt.prepare(u, v, lat, lon, cal_dtype="float64", device="cpu")
    base = dict(zwn=(3.0,), sw_lon=40.0, sw_lat=25.0, dlon=1.0, dlat=1.0,
                nnx=1, nny=1, ttotal=2 * 86400.0, cal_dtype="float64")
    ref = pt.trace_rays(bs, pt.RunConfig(integrator="rk45", tstep=2 * 3600.0,
                                         rtol=1e-12, atol=1e-12, **base))
    errs = {}
    for tstep in (4 * 3600.0, 2 * 3600.0):
        t = pt.trace_rays(bs, pt.RunConfig(integrator="rk4", tstep=tstep,
                                           **base))
        stride = int(tstep // (2 * 3600.0))
        la, lo = t.lat[:, 0, 0, 0].numpy(), t.lon[:, 0, 0, 0].numpy()
        la_r = ref.lat[::stride, 0, 0, 0].numpy()[: len(la)]
        lo_r = ref.lon[::stride, 0, 0, 0].numpy()[: len(lo)]
        ok = np.isfinite(la) & np.isfinite(la_r)
        assert ok.sum() > 6
        errs[tstep] = np.max(np.hypot(la[ok] - la_r[ok], lo[ok] - lo_r[ok]))
    ratio = errs[4 * 3600.0] / errs[2 * 3600.0]
    assert ratio > 8.0, ratio


CFG = dict(zwn=(2.0, 4.0, 6.0), sw_lon=0.0, sw_lat=5.0, dlon=36.0, dlat=8.0,
           nnx=5, nny=4, tstep=DT, cal_dtype="float64", integrator="rk4")


@pytest.mark.parametrize("days", [0.05, 1 / 12, 4])
def test_trace_rays_matches_jax(batch, days):
    """nt = 1, 2 and 49; rootless lanes all-NaN from row 1, as the JAX
    package expands them."""
    bsj, _, _, _ = batch
    bst = convert.basic_state_from_numpy(
        {k: np.asarray(x) for k, x in bsj._asdict().items()}, device="cpu")
    cfg = dict(CFG, ttotal=days * 86400.0)
    ref = rt.trace_rays(bsj, rt.RunConfig(**cfg))
    out = pt.trace_rays(bst, pt.RunConfig(**cfg))
    nt = rt.RunConfig(**cfg).nt
    assert out.lon.shape == (nt, 3, 20, 3)
    assert_close([np.asarray(getattr(ref, k)) for k in ref._fields],
                 [getattr(out, k).numpy() for k in ref._fields],
                 TEN_DAY_BAR)
    rootless = np.isnan(out.ky[0].numpy())
    assert rootless.any()
    assert np.isfinite(out.lon[0].numpy()[rootless]).all()
    assert np.isnan(out.lon[1:].numpy()[:, rootless]).all()


def test_cpu_rk4_has_no_kernel_launch(batch):
    _, _, bgt, seeds = batch
    before = ttracer.RK4_LAUNCHES, tray.LAUNCHES
    ttracer._run_rk4(bgt, *(torch.as_tensor(x) for x in seeds), DT, 3,
                     CUT_OFF)
    assert (ttracer.RK4_LAUNCHES, tray.LAUNCHES) == before


def test_rhs_fail_flag_matches_jax(batch):
    """The flag the freeze reads: |ky| >= 100 and |lat| >= pi/2 raise it, a
    NaN state does not, in both packages."""
    _, bgj, bgt, _ = batch
    y = np.ones((5, 3))
    y[3, 0] = 150.0
    y[1, 1] = np.pi / 2
    y[3, 2] = np.nan
    _, err = jray.rhs(bgj, jnp.asarray(y))
    np.testing.assert_array_equal(np.asarray(err), [True, True, False])
    np.testing.assert_array_equal(
        tray.rhs(bgt, torch.as_tensor(y))[1].numpy(), np.asarray(err))
