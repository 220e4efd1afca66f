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
step. A float32 sample's group velocity differs from the JAX package's by
up to 2.0e-8 of its scale (the two libraries' float32 sin and cos); its
bar is 10x that, 2e-7.

The RK4 kernel takes a row's (ug, vg) from the next step's first
evaluation (the RHS with the raw group velocity) in place of a separate
``group_velocity_at``, and shares it in a time instance only where the
next step's time equals the row's to the bit: the tests below hold the
plain versions' two samples to each other, bitwise, on the states where
their NaN masks are formed differently, and the port's RK4 chunk to the
JAX package's at a start time where the two times differ.
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
from rwrt_tpu_torch import convert, kernels
from rwrt_tpu_torch import tracer as ttracer
from rwrt_tpu_torch.models import ray as tray
from rwrt_tpu_torch.solvers import rk4 as trk4

DT = 7200.0
CUT_OFF = 0.2
STEP_BAR = 3e-15
TEN_DAY_BAR = 3e-13
STEP_BAR32 = 2e-7


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


#: States at which the RHS and group_velocity_at form their NaN masks
#: differently: the RHS samples a lane with a NaN wavenumber at (0, 0).
GV_STATES = ["live", "killed", "nan_kx", "nan_ky", "polar", "nan_amp"]


@pytest.fixture(scope="module")
def batch32(jet_field):
    """The module's batch over the float32 background, in both packages."""
    u, v, lat, lon = jet_field
    bgj = jtracer.make_background(
        rt.prepare(u, v, lat, lon, cal_dtype="float32"), 0.0)
    bgt = convert.background_from_numpy(
        {k: np.asarray(x) for k, x in bgj._asdict().items() if x is not None},
        device="cpu")
    return bgj, bgt


def gv_state(y0, case, dtype):
    """Eight born lanes of the batch, the first four made ``case``."""
    y = np.array(y0[:, np.flatnonzero(np.isfinite(y0[3]))[:8]])
    edit = {"killed": (slice(None), np.nan), "nan_kx": (2, np.nan),
            "nan_ky": (3, np.nan), "polar": (1, np.pi / 2 + 1e-3),
            "nan_amp": (4, np.nan)}
    if case in edit:
        row, value = edit[case]
        y[row, :4] = value
    if case == "polar":
        y[1, 2:4] = -np.pi / 2 - 0.25
    return y.astype(dtype)


@pytest.mark.parametrize("case", GV_STATES)
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_raw_gv_equals_group_velocity_at(batch, batch32, case, dtype):
    """The RHS's raw (ug, vg) (``_rhs_core(..., with_raw_gv=True)``) equal
    ``group_velocity_at`` at the same state and time, bitwise, NaN masks
    included; both within the bar of the JAX package's ``rhs_and_gv`` and
    ``group_velocity_at``."""
    bgj, bgt = (batch[1], batch[2]) if dtype == "float64" else batch32
    y = gv_state(batch[3][0], case, dtype)
    yt = torch.as_tensor(y)
    _, _, ug, vg = tray._rhs_core(bgt, yt, 0.0, True)
    ug_at, vg_at = tray.group_velocity_at(bgt, *yt[:4])
    assert same(ug, ug_at) and same(vg, vg_at)
    _, ug_j, vg_j = jray.rhs_and_gv(bgj, jnp.asarray(y))
    ug_jat, vg_jat = jray.group_velocity_at(bgj, *jnp.asarray(y)[:4])
    bar = STEP_BAR if dtype == "float64" else STEP_BAR32
    assert_close([np.asarray(x) for x in (ug_j, vg_j, ug_jat, vg_jat)],
                 [x.numpy() for x in (ug, vg, ug_at, vg_at)], bar)
    if case in ("killed", "nan_kx", "nan_ky"):
        assert np.isnan(ug.numpy()[:4]).all()
    assert np.isfinite(ug.numpy()[4:]).all()


#: Start times of a chunk at which some step's time t_start + (s + 1) dt
#: differs from t_s + dt (so the kernel samples a row's (ug, vg) apart
#: from the next evaluation there).
ODD_STARTS = [100.0 / 3.0, 1.0 / 7.0]


def steps_apart(t_start, n_steps, dtype=np.float64):
    """The steps s of a chunk whose time t_start + (s + 1) dt is not the
    previous step's t_s + dt, each formed as the state's dtype forms it."""
    t0, d = dtype(t_start), dtype(DT)
    return [s for s in range(n_steps - 1)
            if t0 + dtype(s + 1) * d != (t0 + dtype(s) * d) + d]


@pytest.mark.parametrize("t_start", ODD_STARTS)
def test_chunk_at_odd_start_matches_jax(jet_field, t_start):
    """The port's RK4 chunk over a time-varying background (3 frames 0.2
    days apart from -0.1 days, float64) from a non-integer start time at
    which the step times differ, against the JAX package's ``_rk4_chunk``,
    within TEN_DAY_BAR."""
    from rwrt_tpu.models.basic_state import prepare_time_varying

    u, v, lat, lon = jet_field
    fu = np.stack([(1.0 + 0.2 * np.sin(k)) * u for k in range(3)])
    fv = np.stack([np.roll(v, 2 * k, axis=0) for k in range(3)])
    bsj = prepare_time_varying(fu, fv, lat, lon, bg_t0=-0.1 * 86400.0,
                               bg_dt=0.2 * 86400.0, cal_dtype="float64")
    bgj = jtracer.make_background(bsj, 0.0)
    bgt = convert.background_from_numpy(
        {k: np.asarray(x) for k, x in bgj._asdict().items() if x is not None},
        device="cpu")
    slon, slat = jtracer.source_matrix(0.0, 5.0, 36.0, 8.0, 5, 4)
    y0 = np.array(jtracer.initialize(bgj, jnp.asarray(slon),
                                     jnp.asarray(slat),
                                     jnp.asarray([2.0, 4.0, 6.0]))[0])
    n = 12
    assert steps_apart(t_start, n)
    y_j, ref = jtracer._rk4_chunk(bgj, jnp.asarray(y0), jnp.asarray(DT), n,
                                  jnp.asarray(CUT_OFF), t_start)
    y_t, out = ttracer._rk4_chunk(bgt, torch.as_tensor(y0), DT, n, CUT_OFF,
                                  t_start)
    assert_close(ref, [x.numpy() for x in out], TEN_DAY_BAR)
    assert_close([np.asarray(y_j)[None]], [y_t.numpy()[None]], TEN_DAY_BAR)
    assert np.isfinite(out[1].numpy()[-1]).any()


#: The RK4 kernel's (state, field, variant) keys.
RK4_KEYS = [(state, field, variant)
            for state, field in ((torch.float32, torch.float32),
                                 (torch.float64, torch.float64),
                                 (torch.float64, torch.float32))
            for variant in ("", "_time")]


@pytest.mark.parametrize("key", RK4_KEYS)
def test_rk4_instance_window(monkeypatch, key):
    """``tracer.rk4_instance`` takes the team exactly in its variant's
    window, ``kernels.RK4_TEAM_LANES``, in every precision, capped by the
    card's resident count (here stand-ins: one that caps nothing, and one
    below the window's top)."""
    dtypes, variant = key[:2], key[2]
    lo, hi = kernels.RK4_TEAM_LANES[variant]
    for resident, top in ((8 * (hi + 100), hi), (8 * (hi - 7), hi - 7)):
        monkeypatch.setattr(kernels, "resident",
                            lambda *a, _r=resident, **k: _r)
        for r, want in ((lo - 1, "lane"), (lo, kernels.TEAM),
                        (top, kernels.TEAM), (top + 1, "lane")):
            assert ttracer.rk4_instance(r, dtypes, variant) == want, (r, top)
