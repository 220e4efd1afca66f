"""Mixed precision (RunConfig.state_dtype='float64'): the port against
rwrt_tpu with a float64 state over a float32 background.

The JAX package's mixed precision is its type promotion applied to a float64
state against float32 fields: the RHS rounds the state to float32 at entry
and runs in float32; each stage sum is float32 and multiplies the float64
step; the error norm, the controller, the dense interpolant's weights, the
kill test and the (ug, vg) of a saved state run in float64. The port writes
those casts out by hand (PyTorch keeps a Python scalar times a float32
tensor in float32).

Bars, each beside its test:

- The RHS on a float64 state is float32 arithmetic in both packages: held to
  1e-6 of each row's max (a float32 ulp is 6e-8 of a value; on this state
  the two agree bitwise).
- Step level: XLA contracts float32 multiply-adds into FMAs inside a
  compiled loop, which moves a stage sum by a float32 ulp and the error
  estimate by up to a few per mille, so the JAX step functions run op by
  op here (``jax.disable_jit``) with the port's RHS (float32, bitwise the
  same function as JAX's on these states): every promotion is then
  checked to 1e-12 of each row's scale, and a float32 ``half * k1`` leaves
  that bar by more than three orders of magnitude.
- ``trace_rays`` end to end (compiled JAX): NaN masks identical and every
  lane within twice the JAX package's own spread under one-ulp moves of
  the float32 sources (lon and lat, both ways), read in the same test, as
  tests/test_torch_trace.py and test_torch_exact.py hold float64 runs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rwrt_tpu as rt
import rwrt_tpu_torch as pt
from rwrt_tpu import tracer as jtracer
from rwrt_tpu.models import ray as jray
from rwrt_tpu.solvers import rk4 as jrk4
from rwrt_tpu.solvers import rk45 as jrk
from rwrt_tpu_torch import convert, kernels
from rwrt_tpu_torch import tracer as ttracer
from rwrt_tpu_torch.kernels import build
from rwrt_tpu_torch.models import ray as tray
from rwrt_tpu_torch.solvers import rk4 as trk4
from rwrt_tpu_torch.solvers import rk45 as trk

DAY = 86400.0
DT = 7200.0
RTOL = ATOL = 1e-6
MIN_STEP = 7.2
CUT_OFF = 0.2
#: Step-level bar, of each row's scale.
STEP_BAR = 1e-12
F64 = jnp.float64


@pytest.fixture(scope="module")
def states(jet_field):
    """The JAX package's float32 basic state and background, and the port's
    carried across with ``convert`` (which keeps the float32 fields)."""
    u, v, lat, lon = jet_field
    bsj = rt.prepare(u, v, lat, lon, cal_dtype="float32")
    bst = convert.basic_state_from_numpy(
        {k: np.asarray(x) for k, x in bsj._asdict().items()}, device="cpu")
    bgj = jtracer.make_background(bsj, 0.0)
    bgt = convert.background_from_numpy(
        {k: np.asarray(x) for k, x in bgj._asdict().items() if x is not None},
        device="cpu")
    return bsj, bst, bgj, bgt


@pytest.fixture(scope="module")
def y64(states):
    """A float64 state over the float32 fields: the initial state of a 5 x 4
    source grid at zwn 2, 4, 6 (180 lanes, rootless ones included), every
    entry moved by up to 1e-9 of itself so that it holds bits no float32
    has."""
    _, _, bgj, _ = states
    slon, slat = jtracer.source_matrix(0.0, 5.0, 36.0, 8.0, 5, 4)
    y0 = np.array(jtracer.initialize(
        bgj, jnp.asarray(slon, jnp.float32), jnp.asarray(slat, jnp.float32),
        jnp.asarray([2.0, 4.0, 6.0], jnp.float32))[0], np.float64)
    rng = np.random.default_rng(5)
    return y0 * (1.0 + rng.uniform(-1e-9, 1e-9, y0.shape))


def port_rhs(bgt, with_gv=False):
    """The port's plain RHS as a JAX-side function of a JAX state (op by op
    only): (dy, err), or (dy, ug, vg) with ``with_gv``."""

    def rhs(yy):
        dy, err, ug, vg = tray._rhs_core(
            bgt, torch.as_tensor(np.array(yy)), 0.0, with_gv)
        out = (dy, ug, vg) if with_gv else (dy, err)
        return tuple(jnp.asarray(x.numpy()) for x in out)

    return rhs


def close(ref, out, bar, name, axis=None):
    """NaN masks identical; |a - b| within ``bar`` of the scale (each row's
    max |value| along ``axis``, or the whole array's)."""
    a, b = np.asarray(ref), np.asarray(out)
    assert a.dtype == b.dtype, (name, a.dtype, b.dtype)
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b), name)
    scale = np.nanmax(np.abs(a), axis=axis, keepdims=axis is not None)
    d = np.nan_to_num(np.abs(a - b)) / np.maximum(scale, 1e-300)
    assert d.max() <= bar, (name, d.max())
    return d.max()


def test_convert_keeps_float32_fields(states):
    _, bst, _, bgt = states
    assert bst.fields.dtype == bgt.fields.dtype == torch.float32


def test_rhs_on_float64_state_matches_jax(states, y64):
    """The state is rounded to float32 at entry (the port's rhs of the
    float64 state is bitwise its rhs of the rounded state), and dy, err and
    the raw (ug, vg) come out float32, within 1e-6 of each row's max of the
    JAX package's."""
    _, _, bgj, bgt = states
    y = torch.as_tensor(y64)
    ref = jray.rhs(bgj, jnp.asarray(y64))
    out = tray.rhs(bgt, y)
    close(ref[0], out[0].numpy(), 1e-6, "dy", axis=1)
    np.testing.assert_array_equal(np.asarray(ref[1]), out[1].numpy())
    rounded = tray.rhs(bgt, y.float())
    assert torch.equal(torch.nan_to_num(out[0]), torch.nan_to_num(rounded[0]))
    ref_gv = jray.rhs_and_gv(bgj, jnp.asarray(y64))
    out_gv = tray.rhs_and_gv(bgt, y)
    for a, b, name in zip(ref_gv, out_gv, ("dy", "ug", "vg")):
        assert b.dtype == torch.float32
        close(a, b.numpy(), 1e-6, name, axis=1 if name == "dy" else None)


def test_group_velocity_at_float64_positions(states, y64):
    """group_velocity_at does not round a float64 state: the cell, the lerp
    over the float32 corners, the Mercator transform and group velocity run
    in float64, within 1e-12 of the JAX package's; at the positions rounded
    to float32 the result moves by more than 100 times that."""
    _, _, bgj, bgt = states
    ref = jray.group_velocity_at(bgj, *(jnp.asarray(y64[i]) for i in range(4)))
    out = tray.group_velocity_at(bgt, *(torch.as_tensor(y64[i])
                                        for i in range(4)))
    for a, b, name in zip(ref, out, ("ug", "vg")):
        close(a, b.numpy(), 1e-12, name)
    rounded = tray.group_velocity_at(
        bgt, *(torch.as_tensor(y64[i]).float().double() for i in range(4)))
    d = np.nanmax(np.abs(out[0].numpy() - rounded[0].numpy()))
    assert d > 1e2 * 1e-12 * np.nanmax(np.abs(out[0].numpy()))


def _float32_half_k1_step(bgt, y, dt):
    """An RK4 step whose first stage input takes 0.5 dt * k1 in float32 (what
    PyTorch's promotion gives without the port's widening)."""
    d, half, sixth = trk4.step_factors(dt, y.dtype)

    def rhs(yy):
        return tray._rhs_core(bgt, yy, 0.0, False)[:2]

    k1, m1 = rhs(y)
    k2, m2 = rhs(y + half * k1)
    k3, m3 = rhs(y + half * k2.double())
    k4, m4 = rhs(y + d * k3.double())
    valid = ~(m1 | m2 | m3 | m4)
    return torch.where(valid[None], y + sixth * (k1 + 2.0 * k2 + 2.0 * k3
                                                 + k4).double(), y)


def test_rk4_step_matches_jax(states, y64, monkeypatch):
    """One RK4 step: stage inputs y + (0.5 dt) k in float64, the stage sum in
    float32, the update in float64, within 1e-12 of each row's scale of
    the JAX package's (op by op, the port's RHS); the same step with a
    float32 0.5 dt * k1 leaves the bar by more than 1e3."""
    _, _, bgj, bgt = states
    rhs = port_rhs(bgt)
    monkeypatch.setattr(jray, "rhs", lambda bg, yy, t=0.0: rhs(yy))
    with jax.disable_jit():
        ref = np.asarray(jrk4.rk4_step(bgj, jnp.asarray(y64),
                                       jnp.asarray(DT, F64)))
    y = torch.as_tensor(y64)
    close(ref, trk4.rk4_step(bgt, y, DT).numpy(), STEP_BAR, "rk4", axis=1)
    bad = _float32_half_k1_step(bgt, y, DT).numpy()
    scale = np.nanmax(np.abs(ref), axis=1, keepdims=True)
    assert np.nanmax(np.abs(bad - ref) / scale) > 1e3 * STEP_BAR


def test_select_initial_step_matches_jax(states, y64):
    """h0 = select_initial_step on a float64 state and its float32 f0:
    y0 + h0 f0 in float64, f1 - f0 in float32, the norms in float64."""
    _, _, _, bgt = states
    rhs = port_rhs(bgt)
    y = torch.as_tensor(y64)
    f0 = tray.RayRHS(bgt)(y)
    with jax.disable_jit():
        ref = jrk.select_initial_step(
            lambda yy, tt=0.0: rhs(yy)[0], jnp.asarray(y64),
            jnp.asarray(f0.numpy()), jnp.asarray(RTOL, F64),
            jnp.asarray(ATOL, F64))
    out = ttracer.initial_step_sizes(bgt, y, RTOL, ATOL)
    assert out.dtype == torch.float64
    close(ref, out.numpy(), STEP_BAR, "h0")


def _entry(bgt, y64):
    y = torch.as_tensor(y64)
    return (y, torch.zeros(y.shape[1], dtype=torch.float64),
            ttracer.initial_step_sizes(bgt, y, RTOL, ATOL),
            tray.RayRHS(bgt)(y))


#: Output bounds of the first-trips tests: close enough that the first
#: trips cross some.
TRIP_BOUNDS = np.arange(1, 17) * 300.0


@pytest.mark.parametrize("trips", [1, 2, 3])
@pytest.mark.parametrize("mode", ["exact", "dense"])
def test_first_trips_match_jax(states, y64, mode, trips):
    """The first trips of integrate_group (exact) and integrate_group_dense
    (pin (2, 0), so the pin arm fires): hist, y, t, h in float64 and the
    FSAL carry f in float32, within 1e-12 of each row's scale of the JAX
    package's (op by op, the port's RHS)."""
    _, _, _, bgt = states
    y, t, h, f = _entry(bgt, y64)
    rhs, rhs_gv = port_rhs(bgt), port_rhs(bgt, True)
    bounds = torch.as_tensor(TRIP_BOUNDS)
    jargs = [jnp.asarray(x.numpy()) for x in (y, t, h, f, bounds)]
    scalars = [jnp.asarray(x, F64) for x in (RTOL, ATOL, MIN_STEP)]
    with jax.disable_jit():
        if mode == "exact":
            ref = jrk.integrate_group(
                lambda yy, tt=0.0: rhs(yy)[0], lambda yy, tt=0.0: rhs_gv(yy),
                *jargs, jargs[0][0], jargs[0][1], jnp.asarray(CUT_OFF, F64),
                *scalars, trips)
        else:
            ref = jrk.integrate_group_dense(
                lambda yy, tt=0.0: rhs(yy)[0], *jargs, *scalars, trips,
                pin_limit=2, pin_mwn=0.0)
    if mode == "exact":
        out = trk.integrate_group(
            tray.RayRHS(bgt), lambda yy, tt=0.0: tray.rhs_and_gv(bgt, yy, tt),
            y, t, h, f, bounds, y[0], y[1], CUT_OFF, RTOL, ATOL, MIN_STEP,
            trips)
    else:
        out = trk.integrate_group_dense(
            tray.RayRHS(bgt), y, t, h, f, bounds, RTOL, ATOL, MIN_STEP,
            trips, pin_limit=2, pin_mwn=0.0)
    for i, name in ((0, "hist"), (1, "y"), (2, "t"), (3, "h"), (4, "f")):
        close(ref[i], out[i].numpy(), STEP_BAR, name)
    assert out[4].dtype == torch.float32 and out[1].dtype == torch.float64
    if trips == 3:
        assert np.isfinite(out[0][:, 0].numpy()).any()


CFG = dict(zwn=(2.0, 4.0, 6.0), sw_lon=0.0, sw_lat=5.0, dlon=36.0,
           dlat=8.0, nnx=3, nny=2, tstep=DT, ttotal=4 * DAY,
           cal_dtype="float32", state_dtype="float64")
BRANCHES = {
    "rk4": dict(),
    "exact": dict(integrator="rk45", interval_batch=4),
    "barrier": dict(integrator="rk45", interval_batch=1),
    "dense": dict(integrator="rk45", bound_mode="dense", interval_batch=16,
                  pin_limit=500, pin_mwn=0.0),
    "dense_nopin": dict(integrator="rk45", bound_mode="dense",
                        interval_batch=16),
}


def per_lane_diff(a, b):
    """max over output steps of max(|dlon|, |dlat|) in rad, per live lane."""
    la, lb = np.asarray(a.lat), np.asarray(b.lat)
    dlon = np.asarray(a.lon) - np.asarray(b.lon)
    dlon = (dlon + np.pi) % (2 * np.pi) - np.pi
    d = np.nanmax(np.maximum(np.abs(dlon), np.abs(la - lb)), axis=0)
    return d[np.isfinite(d)]


@pytest.fixture(scope="module")
def runs(states):
    """Per branch, lazily: the JAX package's run, its runs from the sources
    moved one float32 ulp (lon and lat, both ways) and the port's run, all
    on the float32 sources of CFG."""
    bsj, bst, _, _ = states
    cache = {}

    def get(branch):
        if branch not in cache:
            cfg = dict(CFG, **BRANCHES[branch])
            jc, tc = rt.RunConfig(**cfg), pt.RunConfig(**cfg)
            slon, slat = (np.asarray(x, np.float32) for x in
                          jtracer.source_matrix(jc.sw_lon, jc.sw_lat, jc.dlon,
                                                jc.dlat, jc.nnx, jc.nny))
            ref = rt.trace_rays(bsj, jc, source_lon=slon, source_lat=slat)
            inf = np.float32(np.inf)
            moves = [(np.nextafter(slon, s * inf), slat) for s in (1, -1)]
            moves += [(slon, np.nextafter(slat, s * inf)) for s in (1, -1)]
            spread = np.max([per_lane_diff(ref, rt.trace_rays(
                bsj, jc, source_lon=lo, source_lat=la)) for lo, la in moves],
                axis=0)
            out = pt.trace_rays(bst, tc, source_lon=slon, source_lat=slat)
            cache[branch] = ref, spread, out
        return cache[branch]

    return get


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_trace_rays_matches_jax(runs, branch):
    """rk4, exact grouped, exact barrier and dense with and without pin over
    4 days: all seven outputs float64, NaN masks identical at every step,
    every lane within twice the JAX package's own one-ulp spread."""
    ref, spread, out = runs(branch)
    for name in ref._fields:
        a, b = np.asarray(getattr(ref, name)), getattr(out, name).numpy()
        assert a.dtype == b.dtype == np.float64, name
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b), name)
    d = per_lane_diff(ref, out)
    assert d.size == spread.size and d.size > 0
    assert d.max() <= 2 * spread.max(), (d.max(), spread.max())
    # The rootless lanes: frozen float64 seed rows in rk45, NaN in rk4.
    rootless = np.isnan(out.ky[0].numpy())
    assert rootless.any()
    lon = out.lon.numpy()[:, rootless]
    if branch == "rk4":
        assert np.isnan(lon[1:]).all()
    else:
        assert (lon == lon[0]).all()


def test_grouped_and_barrier_agree_on_state_rows(states, runs):
    """The grouped exact run equals the barrier run bitwise in every state
    row, as in the JAX package. Their (ug, vg) differ as the JAX package's
    do: the barrier run's are group_velocity_at at its float64 rows
    (bitwise), the grouped run's the 7th stage's float32 sample; the two
    differences are of one size (within 2x of each other, both nonzero)."""
    _, _, _, bgt = states
    (jg, _, g), (jb, _, b) = runs("exact"), runs("barrier")
    for name in ("lon", "lat", "kx", "ky", "amp"):
        x, y = getattr(g, name).numpy(), getattr(b, name).numpy()
        np.testing.assert_array_equal(np.isnan(x), np.isnan(y), name)
        np.testing.assert_array_equal(np.nan_to_num(x), np.nan_to_num(y),
                                      name)
    gv = tray.group_velocity_at(bgt, b.lon[1:].reshape(-1),
                                b.lat[1:].reshape(-1), b.kx[1:].reshape(-1),
                                b.ky[1:].reshape(-1))
    for got, want in zip((b.ug[1:], b.vg[1:]), gv):
        np.testing.assert_array_equal(
            np.nan_to_num(got.reshape(-1).numpy(), nan=7.0),
            np.nan_to_num(want.numpy(), nan=7.0))
    for name in ("ug", "vg"):
        port = np.nanmax(np.abs(getattr(g, name).numpy()
                                - getattr(b, name).numpy()))
        jax_ = np.nanmax(np.abs(np.asarray(getattr(jg, name))
                                - np.asarray(getattr(jb, name))))
        assert port > 0 and jax_ > 0
        assert jax_ / 2 <= port <= 2 * jax_, (name, port, jax_)


def test_one_bound_groups_equal_the_barrier_path_bitwise(states, y64):
    """What the card runs for interval_batch 1 (``_exact_run`` with one
    bound per group and the barrier flag) equals the CPU barrier path
    (``_run_rk45`` over ``_rk45_chunk``) bitwise in mixed precision too,
    (ug, vg) included."""
    _, _, _, bgt = states
    y, _, h, f = _entry(bgt, y64)
    ug, vg = tray.group_velocity_at(bgt, y[0], y[1], y[2], y[3],
                                    zero_invalid=True)
    nt = 5
    run = ttracer._exact_run_plain(
        bgt, y, ug, vg, h, f,
        ttracer.padded_bounds(DT, nt, 1, torch.float64, "cpu"), nt - 1,
        CUT_OFF, RTOL, ATOL, MIN_STEP, 100_000, barrier=True)
    barrier = ttracer._run_rk45(bgt, y, ug, vg, DT, nt, CUT_OFF, RTOL, ATOL,
                                MIN_STEP)
    for a, b in zip(run[:3], barrier[:3]):
        assert a.dtype == torch.float64
        assert torch.equal(torch.isnan(a), torch.isnan(b))
        assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(b))


@pytest.fixture(scope="module")
def sheared_jet():
    """tests/test_mixed_precision.py's background."""
    nlon, nlat = 96, 49
    lat = np.linspace(-np.pi / 2, np.pi / 2, nlat)
    lon = np.arange(nlon) * 2 * np.pi / nlon
    u = (25 * np.cos(lat)[None, :] ** 2
         + 30 * np.exp(-(((np.degrees(lat)[None, :] - 35) / 12.0) ** 2))
         + 6 * np.cos(3 * lon)[:, None] * np.cos(lat)[None, :] ** 2)
    v = 4 * np.sin(2 * lon)[:, None] * np.cos(lat)[None, :]
    return u, v, lat, lon


def _drift(a, ref):
    d = np.abs(np.degrees(a.lat.numpy() - ref.lat.numpy()))
    return np.sqrt(np.nanmean(np.where(np.isfinite(d), d, 0.0) ** 2))


@pytest.mark.parametrize("integrator", ["rk45", "rk4"])
def test_mixed_precision_reduces_float32_drift(sheared_jet, integrator):
    """tests/test_mixed_precision.py's claim, for the port alone: against
    its float64 run, mixed precision at most halves the adaptive path's
    10-day drift of pure float32 (rk4, ~120 fixed steps dominated by the
    float32 RHS: no regression), and both stay small."""
    u, v, lat, lon = sheared_jet
    cfg = dict(zwn=(3.0, 5.0), sw_lon=0.0, sw_lat=15.0, dlon=60.0,
               dlat=10.0, nnx=3, nny=2, tstep=DT, ttotal=10 * DAY,
               integrator=integrator)
    ref = pt.trace_rays(pt.prepare(u, v, lat, lon, cal_dtype="float64",
                                   device="cpu"),
                        pt.RunConfig(cal_dtype="float64", **cfg))
    bs32 = pt.prepare(u, v, lat, lon, cal_dtype="float32", device="cpu")
    pure = pt.trace_rays(bs32, pt.RunConfig(**cfg))
    mixed = pt.trace_rays(bs32, pt.RunConfig(state_dtype="float64", **cfg))
    assert mixed.lat.dtype == torch.float64
    d_pure, d_mixed = _drift(pure, ref), _drift(mixed, ref)
    if integrator == "rk45":
        assert d_mixed < 0.5 * d_pure, (d_pure, d_mixed)
    else:
        assert d_mixed <= d_pure * 1.05, (d_pure, d_mixed)
    assert d_pure < 0.1 and d_mixed < 0.05


@pytest.mark.parametrize("branch", ["rk4", "exact", "dense"])
def test_float64_fields_make_it_a_no_op(jet_field, branch):
    """cal_dtype float64 with state_dtype float64 is the plain float64 run,
    bitwise."""
    u, v, lat, lon = jet_field
    bs = pt.prepare(u, v, lat, lon, cal_dtype="float64", device="cpu")
    cfg = dict(CFG, cal_dtype="float64", ttotal=2 * DAY, **BRANCHES[branch])
    a = pt.trace_rays(bs, pt.RunConfig(**cfg))
    b = pt.trace_rays(bs, pt.RunConfig(**dict(cfg, state_dtype="compute")))
    for name in a._fields:
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype == torch.float64
        assert torch.equal(torch.isnan(x), torch.isnan(y))
        assert torch.equal(torch.nan_to_num(x), torch.nan_to_num(y))


@pytest.mark.parametrize("branch", ["mesh"])
def test_unported_branches_still_raise_in_mixed(states, branch):
    """In mixed precision too, a ``mesh`` that is not a
    ``parallel.sharding.Mesh`` raises TypeError (the mesh's mixed runs:
    tests/test_torch_parallel.py)."""
    _, bst, _, _ = states
    cfg = dict(CFG, ttotal=2 * DAY)
    with pytest.raises(TypeError, match="Mesh"):
        pt.trace_rays(bst, pt.RunConfig(**cfg), mesh=object())


def test_launch_keys_and_refusals(states, y64):
    """The kernels take one type or a float64 state over float32 fields
    (``_mix``: the integrator kernels, whole run and single group, not the
    RHS and spectral ones), refused before anything is built or launched.
    The single-group entry points have their mixed instance: each is
    defined by one macro that the sources instantiate for ``mix`` too, so
    it takes the arguments ``build.SIGNATURES`` passes."""
    import re

    _, _, _, bgt = states
    y = torch.as_tensor(y64)
    assert kernels.state_key(y, bgt.fields) == (torch.float64, torch.float32)
    assert kernels.dtype_key(torch.float32) == (torch.float32, torch.float32)
    with pytest.raises(ValueError):
        kernels.state_key(y.float(), y)
    with pytest.raises(ValueError):
        kernels.launch("rwrt_rhs", (torch.float64, torch.float32))
    assert set(build.MIXED) <= set(build.SIGNATURES)
    for name, src in (("rwrt_exact_group", "exact_run.cu"),
                      ("rwrt_dense_group", "dense_run.cu")):
        assert name in build.MIXED, name
        text = (build.CSRC / src).read_text()
        macro = re.search(r"#define (RWRT_\w+)\(SUFFIX[^)]*\)[ \\\n]+"
                          rf"int {name}_##SUFFIX\(", text).group(1)
        assert re.search(rf"^{macro}\(mix, double, float\)$", text, re.M), (
            name)
        assert re.search(rf"^{macro}\(f32, float, float\)$", text, re.M), (
            name)
    assert kernels.library.cache_info().currsize == 0


def test_validate_tol_uses_the_state_dtype():
    """rtol is clamped to 100 eps of the state's dtype: 1e-6 stays 1e-6 in
    mixed precision, where float32 raises it to ~1.19e-5."""
    ref = float(jrk.validate_tol(1e-6, np.float64))
    assert trk.validate_tol(1e-6, torch.float64) == ref == 1e-6
    assert trk.validate_tol(1e-6, torch.float32) > 1e-5


def test_mixed_run_takes_more_steps_than_float32(states):
    """The unclamped rtol: the mixed dense run makes more step attempts than
    the float32 one on the same seeding."""
    _, bst, _, _ = states
    cfg = dict(CFG, **BRANCHES["dense"])
    counts = {}
    for state in ("compute", "float64"):
        stats = {}
        pt.trace_rays(bst, pt.RunConfig(**dict(cfg, state_dtype=state)),
                      stats=stats)
        counts[state] = int(stats["lane_att"].sum())
    assert counts["float64"] > counts["compute"], counts
