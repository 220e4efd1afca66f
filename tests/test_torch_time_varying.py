"""Port parity: time-varying backgrounds against the JAX package.

The modules: ``prepare_time_varying``; the five time and member samplers
of ``ops/interp.py``; ``sample_bg``, ``rhs`` and ``rhs_and_gv`` over
time-varying, ensemble and ensemble-of-time-varying backgrounds;
``trace_rays`` on a time-varying state in every branch, one type and mixed
precision; the chunked driver; ``fit_spectral_time`` and ``lerp_coeffs``;
``convert`` of a 4-D state and a 5-D member background.

Inputs: the conftest's ``jet_field`` made time-varying from numpy (its jet
scaled and its wave drifted frame by frame), 3 frames 1.5 days apart from
-0.5 days, float64; seeded positions and times. JAX state is carried
across with ``convert``, so the comparisons isolate each module.

Bars (float64): prepare, betam, ks and q within 1e-12 of each field's max
|value|, fields within 1e-11 of each channel's (the static prepare's bar,
``test_torch_basic_state.py``: XLA contracts the third derivatives'
stencils, 2.8e-12 there in both packages' static prepare too), and each
frame bitwise the port's own ``prepare`` of it; samplers and the RHS within
1e-12 of each channel's max |value| with identical NaN patterns; RK4
trajectories within 1e-10 (the JAX package's own time-varying bar); the
adaptive runs with NaN masks identical at every step and every lane within
twice the JAX package's own spread under a one-ulp move of the sources,
read in the same test (``test_torch_trace.py``'s bar); constant frames
against the static background within the JAX package's own tolerances
(``tests/test_time_varying.py``: 1e-10 rk4, 1e-6 rk45).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import rwrt_tpu as rt
from rwrt_tpu import tracer as jtracer
from rwrt_tpu.models import ray as jray
from rwrt_tpu.models.basic_state import prepare_time_varying as jprepare_tv
from rwrt_tpu.ops import interp as jinterp
from rwrt_tpu.ops import spectral_sample as jspec
from rwrt_tpu.utils import checkpoint as jck
import rwrt_tpu_torch as pt
from rwrt_tpu_torch import convert
from rwrt_tpu_torch import tracer as ttracer
from rwrt_tpu_torch.models import ray as tray
from rwrt_tpu_torch.ops import interp as tinterp
from rwrt_tpu_torch.ops import spectral_sample as tspec
from rwrt_tpu_torch.utils import checkpoint as tck

DAY = 86400.0
T0, DT = -0.5 * DAY, 1.5 * DAY
CFG = dict(zwn=(2.0, 4.0), sw_lon=0.0, sw_lat=10.0, dlon=90.0, dlat=10.0,
           nnx=2, nny=2, tstep=7200.0, ttotal=4 * DAY, cal_dtype="float64")
BAR = 1e-12


def wind_frames(jet_field, nt=3, scale=1.0):
    u, v, lat, lon = jet_field
    fu = np.stack([scale * (1.0 + 0.3 * np.sin(1.3 * k)) * u
                   for k in range(nt)])
    fv = np.stack([np.roll(v, 3 * k, axis=0) * (1.0 + 0.2 * k)
                   for k in range(nt)])
    return fu, fv, lat, lon


def to_numpy(state):
    return {k: np.asarray(x) for k, x in state._asdict().items()
            if x is not None}


@pytest.fixture(scope="module")
def states(jet_field):
    """The time-varying state in both packages (the port's carried across
    from the JAX one), and the static state of frame 0."""
    fu, fv, lat, lon = wind_frames(jet_field)
    bsj = jprepare_tv(fu, fv, lat, lon, bg_t0=T0, bg_dt=DT,
                      cal_dtype="float64")
    bst = convert.basic_state_from_numpy(to_numpy(bsj), device="cpu")
    return bsj, bst


def assert_close(a, b, name, axis, bar=BAR):
    """NaN patterns equal; |a - b| within ``bar`` of the max |a| along
    ``axis`` (the lanes), channel by channel."""
    a = np.asarray(a)
    b = b.numpy() if torch.is_tensor(b) else np.asarray(b)
    assert a.shape == b.shape, (name, a.shape, b.shape)
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=name)
    fin = np.isfinite(a)
    scale = np.max(np.abs(np.where(fin, a, 0.0)), axis=axis, keepdims=True)
    err = np.abs(np.where(fin, a - b, 0.0)) / np.maximum(scale, 1e-300)
    assert err.max() <= bar, (name, err.max())


def test_prepare_time_varying_matches_jax(jet_field, states):
    bsj, _ = states
    fu, fv, lat, lon = wind_frames(jet_field)
    out = pt.prepare_time_varying(fu, fv, lat, lon, bg_t0=T0, bg_dt=DT,
                                  cal_dtype="float64", device="cpu")
    assert (out.bg_t0, out.bg_dt) == (T0, DT)
    assert out.fields.shape == (3, 73, 37, 18)
    assert_close(bsj.fields, out.fields, "fields", axis=(0, 1, 2),
                 bar=1e-11)
    for k in ("betam", "ks", "q"):
        assert_close(getattr(bsj, k), getattr(out, k), k, axis=None)
    for i in range(3):
        own = pt.prepare(fu[i], fv[i], lat, lon, cal_dtype="float64",
                         device="cpu")
        for k in ("fields", "betam", "ks", "q"):
            a, b = getattr(own, k), getattr(out, k)[i]
            assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(b)), k


def test_prepare_time_varying_checks_its_axes(jet_field):
    fu, fv, lat, lon = wind_frames(jet_field)
    with pytest.raises(ValueError, match="3-D"):
        pt.prepare_time_varying(fu[0], fv[0], lat, lon, bg_dt=DT,
                                device="cpu")
    with pytest.raises(ValueError, match="3-D"):
        pt.prepare_time_varying(fu, fv[:2], lat, lon, bg_dt=DT,
                                device="cpu")
    with pytest.raises(ValueError, match="uniform"):
        pt.prepare_time_varying(fu, fv, lat ** 3, lon, bg_dt=DT,
                                device="cpu")


@pytest.fixture(scope="module")
def positions():
    """Seeded positions (NaN, polar, west of the origin and past 2 pi),
    fractional frame indices inside the range, on the frames, beyond both
    ends and NaN, and member ids 0..2."""
    rng = np.random.default_rng(21)
    n = 2000
    lon = rng.uniform(-1.0, 7.3, n)
    lat = rng.uniform(-1.65, 1.65, n)
    lat[:30] = np.pi / 2 - 1e-3
    lon[30:45] = np.nan
    lat[45:60] = np.nan
    tfrac = rng.uniform(-0.7, 2.9, n)
    tfrac[60:90] = np.arange(30) % 3           # on the frames
    tfrac[90:110] = -3.5                        # before frame 0
    tfrac[110:130] = 7.25                       # past the last frame
    tfrac[130:135] = np.nan
    member = (np.arange(n) % 3).astype(np.int32)
    return lon, lat, tfrac, member


def member_stacks(jet_field, packed_frames):
    """(M, W, H, 48) and (M, T, W, H, 48) packed stacks of three members
    (the state scaled), as JAX arrays."""
    static = jnp.stack([s * packed_frames[0] for s in (0.8, 1.0, 1.2)])
    varying = jnp.stack([s * packed_frames for s in (0.8, 1.0, 1.2)])
    return static, varying


SAMPLERS = ["sample_raw_time", "sample_mercator_time",
            "sample_raw_packed_time", "sample_raw_packed_member",
            "sample_raw_packed_member_time"]


@pytest.mark.parametrize("name", SAMPLERS)
def test_samplers_match_jax(jet_field, states, positions, name):
    bsj, _ = states
    lon, lat, tfrac, member = positions
    bgj = jtracer.make_background(bsj, 0.0)
    grid = (bgj.lon0, bgj.lat0, bgj.dx, bgj.dy)
    tgrid = tuple(float(x) for x in grid)
    if name in ("sample_raw_time", "sample_mercator_time"):
        fields = bsj.fields
    elif name == "sample_raw_packed_time":
        fields = bgj.fields
    else:
        static, varying = member_stacks(jet_field, bgj.fields)
        fields = static if name == "sample_raw_packed_member" else varying
    extra_j, extra_t = [], []
    if "member" in name:
        extra_j.append(jnp.asarray(member))
        extra_t.append(torch.as_tensor(member))
    if "time" in name:
        extra_j.append(jnp.asarray(tfrac))
        extra_t.append(torch.as_tensor(tfrac))
    ref = getattr(jinterp, name)(fields, *grid, jnp.asarray(lon),
                                 jnp.asarray(lat), *extra_j)
    out = getattr(tinterp, name)(torch.as_tensor(np.asarray(fields)),
                                 *tgrid, torch.as_tensor(lon),
                                 torch.as_tensor(lat), *extra_t)
    assert_close(ref, out, name, axis=1 if "mercator" in name else 0)
    # The seeded cases occur: NaN rows and finite rows.
    assert np.isnan(np.asarray(ref)).any() and np.isfinite(
        np.asarray(ref)).any()


def backgrounds_of(kind, bsj, jet_field, lanes):
    """The JAX background of ``kind`` and the port's carried across."""
    bgj = jtracer.make_background(bsj, 0.0)
    if kind != "time":
        static, varying = member_stacks(jet_field, bgj.fields)
        bgj = bgj._replace(
            fields=static if kind == "member" else varying,
            member_ids=jnp.asarray((np.arange(lanes) % 3).astype(np.int32)))
    return bgj, convert.background_from_numpy(to_numpy(bgj), device="cpu")


@pytest.fixture(scope="module")
def ray_states():
    rng = np.random.default_rng(5)
    n = 1500
    y = np.stack([rng.uniform(-1.0, 7.3, n), rng.uniform(-1.65, 1.65, n),
                  rng.uniform(0.5, 7.5, n), rng.normal(0.0, 40.0, n),
                  rng.uniform(0.5, 2.0, n)])
    for row, sl in ((0, np.s_[:20]), (3, np.s_[20:40]), (4, np.s_[40:60])):
        y[row, sl] = np.nan
    t = rng.uniform(-2.0 * DAY, 5.0 * DAY, n)
    return y, t


@pytest.mark.parametrize("fn", ["sample_bg", "rhs", "rhs_and_gv"])
@pytest.mark.parametrize("kind", ["time", "member", "member_time"])
def test_sample_bg_and_rhs_match_jax(jet_field, states, ray_states, kind,
                                     fn):
    """Per-lane times over, between and past the frames; an ensemble's
    member map also tiled over a (3 R,) call to ``sample_bg``."""
    y, t = ray_states
    bgj, bgt = backgrounds_of(kind, states[0], jet_field, y.shape[1])
    if fn == "sample_bg":
        lon, lat = np.tile(y[0], 3), np.tile(y[1], 3)
        tt = np.tile(t, 3)
        ref = jray.sample_bg(bgj, jnp.asarray(lon), jnp.asarray(lat),
                             jnp.asarray(tt))
        out = tray.sample_bg(bgt, torch.as_tensor(lon), torch.as_tensor(lat),
                             torch.as_tensor(tt))
        assert_close(ref, out, fn, axis=1)
        return
    ref = getattr(jray, fn)(bgj, jnp.asarray(y), jnp.asarray(t))
    out = getattr(tray, fn)(bgt, torch.as_tensor(y), torch.as_tensor(t))
    assert_close(ref[0], out[0], "dy", axis=1)
    if fn == "rhs":
        np.testing.assert_array_equal(np.asarray(ref[1]), out[1].numpy())
    else:
        assert_close(ref[1], out[1], "ug", axis=0)
        assert_close(ref[2], out[2], "vg", axis=0)


def test_mixed_rhs_rounds_the_time_at_entry(jet_field, ray_states):
    """A float64 state and time over a float32 time-varying background:
    both are rounded to float32 at entry, so the time lerp's fraction is
    taken in float32 (the JAX package's cast, ``ray.py:169-172``), op by op
    bitwise equal to the JAX package's; and the same as the port's RHS on
    the rounded inputs."""
    fu, fv, lat, lon = wind_frames(jet_field)
    bsj = jprepare_tv(fu, fv, lat, lon, bg_t0=T0, bg_dt=DT,
                      cal_dtype="float32")
    bgj = jtracer.make_background(bsj, 0.0)
    bgt = convert.background_from_numpy(to_numpy(bgj), device="cpu")
    y, t = ray_states
    t = t + 0.37  # fractions float32 cannot hold
    with jax.disable_jit():
        ref = jray.rhs_and_gv(bgj, jnp.asarray(y), jnp.asarray(t))
    out = tray.rhs_and_gv(bgt, torch.as_tensor(y), torch.as_tensor(t))
    rounded = tray.rhs_and_gv(bgt, torch.as_tensor(y).float(),
                              torch.as_tensor(t).float())
    for a, b, c, name in zip(ref, out, rounded, ("dy", "ug", "vg")):
        assert b.dtype == torch.float32, name
        assert torch.equal(torch.nan_to_num(b), torch.nan_to_num(c)), name
        assert_close(a, b, name, axis=-1, bar=1e-6)


def rows(traj):
    f = [np.asarray(getattr(traj, k)) for k in traj._fields]
    nt = f[0].shape[0]
    return np.stack([x.reshape(nt, -1) for x in f], axis=1)


def per_lane_diff(a, b):
    a, b = rows(a), rows(b)
    dlon = (a[:, 0] - b[:, 0] + np.pi) % (2 * np.pi) - np.pi
    d = np.nanmax(np.maximum(np.abs(dlon), np.abs(a[:, 1] - b[:, 1])),
                  axis=0)
    return d[np.isfinite(d)]


def assert_masks(ref, out):
    a, b = rows(ref), rows(out)
    assert a.shape == b.shape
    for step in range(a.shape[0]):
        np.testing.assert_array_equal(np.isnan(a[step]), np.isnan(b[step]),
                                      err_msg=f"step {step}")


def jax_spread(run, bs, cfg):
    """The JAX package against itself with the source longitudes and
    latitudes each moved by one ulp of the background's dtype, both ways:
    the largest per-lane differences (``run`` a JAX driver), as
    ``test_torch_mixed.py`` reads it."""
    dtype = np.asarray(bs.fields).dtype
    slon, slat = (np.asarray(x, dtype) for x in jtracer.source_matrix(
        cfg.sw_lon, cfg.sw_lat, cfg.dlon, cfg.dlat, cfg.nnx, cfg.nny))
    ref = run(bs, cfg, source_lon=slon, source_lat=slat)
    inf = dtype.type(np.inf)
    moves = [(np.nextafter(slon, s * inf), slat) for s in (1, -1)]
    moves += [(slon, np.nextafter(slat, s * inf)) for s in (1, -1)]
    return np.max([per_lane_diff(ref, run(bs, cfg, source_lon=lo,
                                           source_lat=la))
                   for lo, la in moves], axis=0)


BRANCHES = {
    "rk4": dict(integrator="rk4"),
    "exact": dict(integrator="rk45", interval_batch=16),
    "barrier": dict(integrator="rk45", interval_batch=1),
    "dense_pin": dict(integrator="rk45", bound_mode="dense",
                      interval_batch=16, pin_limit=500, pin_mwn=0.0),
    "dense": dict(integrator="rk45", bound_mode="dense", interval_batch=16),
    "mixed_dense": dict(integrator="rk45", bound_mode="dense",
                        interval_batch=16, pin_limit=500, pin_mwn=0.0,
                        cal_dtype="float32", state_dtype="float64"),
    "mixed_exact": dict(integrator="rk45", interval_batch=16,
                        cal_dtype="float32", state_dtype="float64"),
}


def assert_within_spread(ref, out, spread):
    d = per_lane_diff(ref, out)
    assert d.size and d.max() <= 2 * max(spread.max(), 1e-12), (
        d.max(), spread.max())


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_trace_rays_matches_jax(jet_field, states, branch):
    cfg = dict(CFG, **BRANCHES[branch])
    if cfg["cal_dtype"] == "float32":
        fu, fv, lat, lon = wind_frames(jet_field)
        bsj = jprepare_tv(fu, fv, lat, lon, bg_t0=T0, bg_dt=DT,
                          cal_dtype="float32")
        bst = convert.basic_state_from_numpy(to_numpy(bsj), device="cpu")
    else:
        bsj, bst = states
    jcfg, tcfg = rt.RunConfig(**cfg), pt.RunConfig(**cfg)
    ref = rt.trace_rays(bsj, jcfg)
    out = pt.trace_rays(bst, tcfg)
    assert_masks(ref, out)
    if branch == "rk4":
        a, b = rows(ref), rows(out)
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-10)
    else:
        assert_within_spread(ref, out, jax_spread(rt.trace_rays, bsj, jcfg))
    if cfg.get("state_dtype") == "float64":
        assert all(getattr(out, k).dtype == torch.float64
                   for k in out._fields)


@pytest.mark.parametrize("integrator", ["rk4", "rk45"])
def test_constant_frames_equal_static(jet_field, integrator):
    u, v, lat, lon = jet_field
    static = pt.prepare(u, v, lat, lon, cal_dtype="float64", device="cpu")
    tv = pt.prepare_time_varying(np.stack([u, u, u]), np.stack([v, v, v]),
                                 lat, lon, bg_t0=0.0, bg_dt=2 * DAY,
                                 cal_dtype="float64", device="cpu")
    cfg = pt.RunConfig(**dict(CFG, integrator=integrator))
    a, b = pt.trace_rays(static, cfg), pt.trace_rays(tv, cfg)
    atol = 1e-10 if integrator == "rk4" else 1e-6
    for k in a._fields:
        np.testing.assert_allclose(getattr(a, k).numpy(),
                                   getattr(b, k).numpy(), rtol=0, atol=atol,
                                   equal_nan=True, err_msg=k)


def test_varying_background_moves_trajectories(jet_field, states):
    _, bst = states
    u, v, lat, lon = jet_field
    fu, fv, _, _ = wind_frames(jet_field)
    static = pt.prepare(fu[0], fv[0], lat, lon, cal_dtype="float64",
                        device="cpu")
    cfg = pt.RunConfig(**dict(CFG, integrator="rk4"))
    a, b = pt.trace_rays(static, cfg), pt.trace_rays(bst, cfg)
    la, lb = a.lat.numpy(), b.lat.numpy()
    both = np.isfinite(la) & np.isfinite(lb)
    assert np.nanmax(np.abs(la[both] - lb[both])) > 1e-3


@pytest.mark.parametrize("branch", ["rk4", "dense_pin"])
def test_chunked_driver_matches_jax(states, branch):
    """``trace_rays_chunked`` with sort_rays (the lane sort reads the
    trailing grid dimensions of a 4-D stack) against the JAX driver, and
    bitwise against the port's ``trace_rays`` with chunks of its group."""
    bsj, bst = states
    cfg = dict(CFG, **BRANCHES[branch])
    jcfg, tcfg = rt.RunConfig(**cfg), pt.RunConfig(**cfg)
    ref = jck.trace_rays_chunked(bsj, jcfg, chunk_steps=16, verbose=False,
                                 sort_rays=True)
    out = tck.trace_rays_chunked(bst, tcfg, chunk_steps=16, verbose=False,
                                 sort_rays=True)
    assert_masks(ref, out)
    if branch == "rk4":
        np.testing.assert_allclose(rows(ref), rows(out), rtol=0, atol=1e-10)
    else:
        spread = jax_spread(
            lambda *a, **k: jck.trace_rays_chunked(
                *a, chunk_steps=16, verbose=False, sort_rays=True, **k),
            bsj, jcfg)
        assert_within_spread(ref, out, spread)
    one = pt.trace_rays(bst, tcfg)
    for k in one._fields:
        x, y = getattr(one, k), getattr(out, k)
        assert torch.equal(torch.isnan(x), torch.isnan(y)), k
        assert torch.equal(torch.nan_to_num(x), torch.nan_to_num(y)), k


def test_fit_spectral_time_and_lerp_coeffs_match_jax(states):
    bsj, bst = states
    ref = jspec.fit_spectral(bsj)
    out = tspec.fit_spectral(bst)
    assert out.coeffs.shape == tuple(ref.coeffs.shape) == (3, 73, 37, 18)
    assert_close(ref.coeffs, out.coeffs, "coeffs", axis=(0, 1, 2))
    raw = np.asarray(bsj.fields)
    direct = tspec.fit_spectral_time(raw, xcyclic=True,
                                     lon=np.asarray(bsj.lon),
                                     lat=np.asarray(bsj.lat))
    assert torch.equal(direct.coeffs, out.coeffs)
    # Inside the range, on a frame, at the last frame (t0 held to T - 2)
    # and past both ends.
    for tfrac in (0.4, 1.0, 1.75, 2.0, -1.0, 5.0):
        a = jspec.lerp_coeffs(ref, tfrac)
        b = tspec.lerp_coeffs(out, tfrac)
        assert_close(a.coeffs, b.coeffs, f"lerp at {tfrac}", axis=(0, 1))
    lon = torch.linspace(0.1, 6.0, 50, dtype=torch.float64)
    lat = torch.linspace(-1.4, 1.4, 50, dtype=torch.float64)
    a = jspec.sample_spectral(jspec.lerp_coeffs(ref, 0.4), jnp.asarray(lon),
                              jnp.asarray(lat))
    b = tspec.sample_spectral(tspec.lerp_coeffs(out, 0.4), lon, lat)
    assert_close(a, b, "sample", axis=0)
    with pytest.raises(ValueError):
        tspec.lerp_coeffs(tspec.fit_spectral(bst._replace(
            fields=bst.fields[0])), 0.5)
    with pytest.raises(ValueError):
        tspec.fit_spectral(bst.fields)


def test_convert_carries_varying_and_member_state(jet_field, states):
    bsj, bst = states
    assert bst.fields.shape == (3, 73, 37, 18)
    assert (bst.bg_t0, bst.bg_dt) == (T0, DT)
    np.testing.assert_array_equal(np.asarray(bsj.fields), bst.fields.numpy())
    bgj, bgt = backgrounds_of("member_time", bsj, jet_field, 30)
    assert bgt.fields.shape == (3, 3, 73, 37, 48)
    assert bgt.member_ids.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(bgj.member_ids),
                                  bgt.member_ids.numpy())
    np.testing.assert_array_equal(np.asarray(bgj.fields), bgt.fields.numpy())
    assert (bgt.bg_t0, bgt.bg_dt) == (T0, DT)
