"""The adaptive runs' entry stage and the flux region pass on the CPU.

``tracer.entry_stage`` gives (h0, f0): Hairer's initial step and the FSAL
stage at a time t0, one launch of ``csrc/entry.cu`` on a CUDA state. On
a CPU state its plain route runs: (a) holds that route to the composition
the adaptive runs used before it, bitwise (``rk45.select_initial_step``
over ``ray.RayRHS`` with ``f0 = rhs(y0, t0)``), in float32, float64 and
mixed precision (a float64 state over a float32 background), over a
static, a 31-frame time-varying and a member-mapped background, at t0 = 0
and at per-lane times, with rootless lanes (NaN ky and amp); and
``initial_step_sizes`` to the parent's form at t = 0. (b) holds h0 and f0
to the JAX package's ``initial_step_sizes`` and ``rhs`` (and
``select_initial_step`` at per-lane times) in float64, at the step-level
bar of tests/test_torch_rk45.py (1e-12).

The region pass (``flux._region``; on the card ``csrc/flux.cu``
``region_kernel``) ORs "a live point of these rows lies in the box" into
``keep``. (c) holds its plain route to the JAX package's ``region_mask``
and ``_in_box_arrays(...).any(0)`` in the three box modes (every
longitude, a plain range, across the date line), with a ray whose only
in-box row is its last, a NaN amp on a ray's only in-box row, and a
``keep`` carried from one block of rows into the next. The kernels
themselves are held to these plain routes on the card
(tests/test_torch_cuda_kernels.py). Inputs come from numpy seeds; JAX
state is carried across with ``convert``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import rwrt_tpu as rt
from rwrt_tpu import tracer as jtracer
from rwrt_tpu.diagnostics import flux as jflux
from rwrt_tpu.models import ray as jray
from rwrt_tpu.solvers import rk45 as jrk
import rwrt_tpu_torch as pt
from rwrt_tpu_torch import convert
from rwrt_tpu_torch import tracer as ttracer
from rwrt_tpu_torch.diagnostics import flux as pflux
from rwrt_tpu_torch.models import ray as tray
from rwrt_tpu_torch.solvers import rk45 as trk

DAY = 86400.0
ATOL = 1e-6
#: Frames of the time-varying background, a day apart from day -0.5: the
#: per-lane times below fall between them and past both ends.
FRAMES = 31
#: (state, field) dtypes.
KEYS = {"float32": (torch.float32, torch.float32),
        "float64": (torch.float64, torch.float64),
        "mixed": (torch.float64, torch.float32)}
KINDS = ["static", "time", "member"]
BAR = 1e-12


def frames(jet_field, nt=FRAMES, scale=1.0):
    """nt wind frames: the jet's amplitude varies, its wave drifts east."""
    u, v, lat, lon = jet_field
    fu = np.stack([scale * (1.0 + 0.15 * np.sin(0.3 * k)) * u
                   for k in range(nt)])
    fv = np.stack([np.roll(v, k, axis=0) for k in range(nt)])
    return fu, fv, lat, lon


@pytest.fixture(scope="module")
def backgrounds(jet_field):
    """background(kind, field dtype, lanes): a ``kind`` background on the
    CPU, made once a module (a member map cycling over 3 members lane by
    lane for "member")."""
    made = {}

    def make(kind, field):
        u, v, lat, lon = jet_field
        if kind == "time":
            fu, fv, _, _ = frames(jet_field)
            return ttracer.make_background(pt.prepare_time_varying(
                fu, fv, lat, lon, bg_t0=-0.5 * DAY, bg_dt=DAY,
                cal_dtype=field, device="cpu"), 0.0)
        members = [ttracer.make_background(pt.prepare(
            s * u, v, lat, lon, cal_dtype=field, device="cpu"), 0.0)
            for s in ((1.0,) if kind == "static" else (0.9, 1.1, 1.0))]
        if kind == "static":
            return members[0]
        return members[0]._replace(
            fields=torch.stack([m.fields for m in members]).contiguous())

    def background(kind, field, lanes):
        if (kind, field) not in made:
            made[kind, field] = make(kind, field)
        bg = made[kind, field]
        if kind == "member":
            bg = bg._replace(member_ids=torch.arange(
                lanes, dtype=torch.int32) % bg.fields.shape[0])
        return bg

    return background


def entry_lanes(jet_field, state, field):
    """Seeded lanes of a 6 x 5 source grid x zwn 1, 3, 5 over the static
    jet, rootless lanes (NaN ky and amp) kept, in the state's dtype; and
    per-lane times in the first 30 days."""
    u, v, lat, lon = jet_field
    bg = ttracer.make_background(
        pt.prepare(u, v, lat, lon, cal_dtype=field, device="cpu"), 0.0)
    slon, slat = ttracer.source_matrix(10.0, -50.0, 55.0, 20.0, 6, 5)
    y0, _, _ = ttracer.initialize(
        bg, torch.as_tensor(slon, dtype=field),
        torch.as_tensor(slat, dtype=field),
        torch.as_tensor([1.0, 3.0, 5.0], dtype=field))
    y0 = y0.to(state).contiguous()
    t0 = torch.as_tensor(np.random.default_rng(7).uniform(
        0.0, 30 * DAY, y0.shape[1]), dtype=state)
    return y0, t0


def same(a, b):
    return torch.equal(torch.isnan(a), torch.isnan(b)) and torch.equal(
        torch.nan_to_num(a), torch.nan_to_num(b))


@pytest.mark.parametrize("times", ["zero", "per_lane"])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("key", list(KEYS))
def test_entry_stage_plain_equals_composition(jet_field, backgrounds, key,
                                              kind, times):
    """(a): the plain route bitwise the composition it replaces, in the
    state's and the background's dtypes."""
    state, field = KEYS[key]
    y0, t_lanes = entry_lanes(jet_field, state, field)
    assert bool(torch.isnan(y0[4]).any() & torch.isfinite(y0[4]).any())
    r = y0.shape[1]
    bg = backgrounds(kind, field, r)
    t0 = 0.0 if times == "zero" else t_lanes
    rtol = trk.validate_tol(1e-6, state)
    h, f = ttracer.entry_stage(bg, y0, t0, rtol, ATOL)
    rhs = tray.RayRHS(bg)
    f_want = rhs(y0, t0)
    h_want = trk.select_initial_step(rhs, y0, f_want, rtol, ATOL, t0)
    assert h.dtype == state and f.dtype == field
    assert tuple(h.shape) == (r,) and tuple(f.shape) == (5, r)
    assert same(h, h_want) and same(f, f_want)
    assert bool(torch.isfinite(h).any())
    if times == "zero":
        # The parent's forms: initial_step_sizes' RHS at the float t = 0,
        # the grouped runner's f0 at a zero time per lane.
        parent = trk.select_initial_step(rhs, y0, rhs(y0), rtol, ATOL)
        assert same(ttracer.initial_step_sizes(bg, y0, rtol, ATOL), parent)
        assert same(h, parent)
        assert same(f, rhs(y0, torch.zeros_like(y0[0])))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("key", list(KEYS))
def test_entry_stage_h_at_t0_where_samples_ignore_time(jet_field,
                                                       backgrounds, key,
                                                       kind):
    """A resume whose checkpoint holds no h takes it at t = 0
    (``utils.checkpoint``): from the entry stage at the lanes' own times
    where samples of the background do not depend on time (a static stack,
    an ensemble of static members), which needs this to be
    ``initial_step_sizes``' h bitwise; the time-varying stack's differs."""
    state, field = KEYS[key]
    y0, t_lanes = entry_lanes(jet_field, state, field)
    bg = backgrounds(kind, field, y0.shape[1])
    rtol = trk.validate_tol(1e-6, state)
    h = ttracer.entry_stage(bg, y0, t_lanes, rtol, ATOL)[0]
    at0 = ttracer.initial_step_sizes(bg, y0, rtol, ATOL)
    assert tray.timed(bg) == (kind == "time")
    assert same(h, at0) != tray.timed(bg)


def jax_pair(jet_field, kind):
    """(JAX background, the port's carried across), float64."""
    u, v, lat, lon = jet_field
    if kind == "time":
        fu, fv, _, _ = frames(jet_field)
        bsj = rt.prepare_time_varying(fu, fv, lat, lon, bg_t0=-0.5 * DAY,
                                      bg_dt=DAY, cal_dtype="float64")
    else:
        bsj = rt.prepare(u, v, lat, lon, cal_dtype="float64")
    bgj = jtracer.make_background(bsj, 0.0)
    bgt = convert.background_from_numpy(
        {k: np.asarray(x) for k, x in bgj._asdict().items() if x is not None},
        device="cpu")
    return bgj, bgt


def assert_close(want, got, name):
    """NaN patterns equal; each row within BAR of its largest |value|."""
    want = np.asarray(want)
    got = got.numpy()
    np.testing.assert_array_equal(np.isnan(want), np.isnan(got),
                                  err_msg=name)
    fin = np.isfinite(want)
    scale = np.abs(np.where(fin, want, 0.0)).max(axis=-1, keepdims=True)
    err = np.abs(np.where(fin, want - got, 0.0)) / np.maximum(scale, 1e-300)
    assert err.max() <= BAR, (name, err.max())


@pytest.mark.parametrize("times", ["zero", "per_lane"])
@pytest.mark.parametrize("kind", ["static", "time"])
def test_entry_stage_matches_jax(jet_field, kind, times):
    """(b): h0 and f0 against the JAX package's in float64."""
    bgj, bgt = jax_pair(jet_field, kind)
    y0, t_lanes = entry_lanes(jet_field, torch.float64, torch.float64)
    y0n = y0.numpy().copy()
    rtol = trk.validate_tol(1e-6, torch.float64)

    def rhs_fn(yy, tt=0.0):
        return jray.rhs(bgj, yy, tt)[0]

    if times == "zero":
        h, f = ttracer.entry_stage(bgt, y0, 0.0, rtol, ATOL)
        h_j = jtracer.initial_step_sizes(bgj, jnp.asarray(y0n), rtol, ATOL)
        f_j = rhs_fn(jnp.asarray(y0n))
    else:
        tn = t_lanes.numpy().copy()
        h, f = ttracer.entry_stage(bgt, y0, t_lanes, rtol, ATOL)
        f_j = rhs_fn(jnp.asarray(y0n), jnp.asarray(tn))
        h_j = jrk.select_initial_step(rhs_fn, jnp.asarray(y0n), f_j, rtol,
                                      ATOL, jnp.asarray(tn))
    assert_close(f_j, f, "f0")
    assert_close(np.asarray(h_j)[None], h[None], "h0")


#: The region pass's boxes in its three modes.
BOXES = {"circle": ((-180.0, 180.0), (20.0, 60.0)),
         "plain": ((150.0, 240.0), (20.0, 60.0)),
         "dateline": ((170.0, -160.0), (-30.0, 40.0))}


def region_rows(nt, box, r=203, seed=3):
    """(nt, r) lon, lat, amp rows (float64 numpy) of random walks, with
    these rays placed by hand: ray 0's only live in-box point is its last
    row; ray 1's only in-box row has a NaN amp; ray 2 enters the box only
    at row 0; ray 3 is dead (NaN) from row 1; ray 4 stays outside."""
    rng = np.random.default_rng(seed)
    lon = np.cumsum(rng.normal(0, 0.1, (nt, r)), 0) + rng.uniform(
        0, 2 * np.pi, (1, r))
    lat = np.clip(np.cumsum(rng.normal(0, 0.05, (nt, r)), 0)
                  + rng.uniform(-1.2, 1.2, (1, r)), -1.5, 1.5)
    amp = rng.normal(0, 2, (nt, r))
    (lo0, lo1), (la0, la1) = box
    inside = np.radians([lo0 + 1.0 if lo1 > lo0 else lo0 + 1.0,
                         0.5 * (la0 + la1)])
    outside = np.radians([lo0 - 5.0, la1 + 10.0])
    for ray in range(5):
        lon[:, ray], lat[:, ray] = outside
    lon[-1, 0], lat[-1, 0] = inside
    lon[nt // 2, 1], lat[nt // 2, 1] = inside
    amp[nt // 2, 1] = np.nan
    lon[0, 2], lat[0, 2] = inside
    lon[1:, 3] = lat[1:, 3] = amp[1:, 3] = np.nan
    return lon, lat, amp


@pytest.mark.parametrize("mode", list(BOXES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_region_plain_matches_jax(mode, dtype):
    """(c): the region pass's plain route equals the JAX package's
    ``region_mask`` in each box mode, with the hand-placed rays above;
    over (nt, 3, nsource, nzwn) trajectories and (nt, R) rows."""
    box = BOXES[mode]
    lon, lat, amp = region_rows(40, box, r=3 * 7 * 9)
    d = {"lon": lon, "lat": lat, "amp": amp}
    for k in ("kx", "ky", "ug", "vg"):
        d[k] = np.zeros_like(lon)
    shaped = {k: a.reshape(40, 3, 7, 9) for k, a in d.items()}
    np_dt = np.float32 if dtype == torch.float32 else np.float64
    jt = jtracer.RayTrajectories(**{k: jnp.asarray(a.astype(np_dt))
                                    for k, a in shaped.items()})
    want = np.asarray(jflux.region_mask(jt, *box))
    assert want.reshape(-1)[:5].tolist() == [True, False, True, False,
                                             False]
    got = pflux.region_mask(convert.trajectories_from_numpy(
        shaped, device="cpu", dtype=dtype), *box)
    np.testing.assert_array_equal(got.numpy(), want)
    rows = [torch.as_tensor(a.astype(np_dt)) for a in (lon, lat, amp)]
    keep = pflux._region(*rows, torch.zeros(lon.shape[1], dtype=torch.bool),
                         *box)
    np.testing.assert_array_equal(keep.numpy(), want.reshape(-1))
    j_any = np.asarray(jflux._in_box_arrays(
        *(jnp.asarray(a.astype(np_dt)) for a in (lon, lat, amp)),
        *box)).any(0)
    np.testing.assert_array_equal(keep.numpy(), j_any)


@pytest.mark.parametrize("split", [1, 13, 39])
@pytest.mark.parametrize("mode", list(BOXES))
def test_region_keep_carries_across_blocks(mode, split):
    """(c): a ``keep`` carried from rows [0, split) into rows [split, nt)
    equals the JAX package's mask over all the rows; a ray kept by the
    first block stays kept whatever the second holds."""
    box = BOXES[mode]
    lon, lat, amp = region_rows(40, box)
    want = np.asarray(jflux._in_box_arrays(
        *(jnp.asarray(a) for a in (lon, lat, amp)), *box)).any(0)
    rows = [torch.as_tensor(a) for a in (lon, lat, amp)]
    keep = torch.zeros(lon.shape[1], dtype=torch.bool)
    first = pflux._region(*(x[:split] for x in rows), keep, *box)
    assert not bool(keep.any())      # the input is not written
    got = pflux._region(*(x[split:] for x in rows), first, *box)
    np.testing.assert_array_equal(got.numpy(), want)
    assert bool((got | ~first).all())
    assert bool(first[2]) and not bool(first[0])
