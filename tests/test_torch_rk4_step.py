"""Port parity: the one-step RK4 re-run (``solvers/rk4.rk4_step_rays``).

``termination.cause_labels``' RK4 branch advances each dead ray's last
saved state one step from its own time. On the card that is one launch of
``csrc/rk4_run.cu``'s step kernel, held there bitwise to ``rk4_step`` over
the plain stages (tests/test_torch_cuda_kernels.py); on a CPU state
``rk4_step_rays`` is that plain step. Here: its plain route against
``rk4_step`` with the dispatching ``ray.rhs`` (bitwise) and against the
JAX package's ``rk4_step`` on the same states and per-lane times, in
float32, float64 and mixed precision, over a static background and over
daily frames; then the RK4 cause counts of both packages' ``classify`` on
tests/test_torch_classify.py's critical-line field in the same cases.

Bars. One step from the same state: the largest difference from the JAX
package's step measured here is 0 in float64, 4.3e-8 of each row's scale
in float32 and 4.4e-8 in mixed precision, whose stages run in float32
(the two libraries' float32 sin and cos); the bars are
tests/test_torch_rk4.py's, STEP_BAR (float64) and STEP_BAR32. NaN masks
identical. The cause counts are equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import rwrt_tpu as rt
from rwrt_tpu import tracer as jtracer
from rwrt_tpu.diagnostics import termination as jterm
from rwrt_tpu.models.basic_state import prepare_time_varying as jprepare_tv
from rwrt_tpu.solvers import rk4 as jrk4
import rwrt_tpu_torch as pt
from rwrt_tpu_torch import convert, kernels
from rwrt_tpu_torch.diagnostics import termination as pterm
from rwrt_tpu_torch.models import ray as tray
from rwrt_tpu_torch.solvers import rk4 as trk4

from test_torch_classify import CAUSES, CFG, RUNS, critical_line_field  # noqa: F401

DAY = 86400.0
DT = 7200.0
STEP_BAR = 3e-15
STEP_BAR32 = 2e-7
#: The precisions: (cal_dtype, the state's dtype).
PRECISIONS = {"float32": ("float32", np.float32),
              "float64": ("float64", np.float64),
              "mixed": ("float32", np.float64)}


def frames_of(u, v, n=3):
    """``n`` frames of (u, v): the jet scaled and the waves rolled east."""
    fu = np.stack([(1.0 + 0.2 * np.sin(k)) * u for k in range(n)])
    fv = np.stack([np.roll(v, 2 * k, axis=0) for k in range(n)])
    return fu, fv


def backgrounds(jet_field, cal, frames):
    """The JAX background (static, or 3 frames a day apart from day -0.5)
    and the port's carried across."""
    u, v, lat, lon = jet_field
    if frames:
        bsj = jprepare_tv(*frames_of(u, v), lat, lon, bg_t0=-0.5 * DAY,
                          bg_dt=DAY, cal_dtype=cal)
    else:
        bsj = rt.prepare(u, v, lat, lon, cal_dtype=cal)
    bgj = jtracer.make_background(bsj, 0.0)
    bgt = convert.background_from_numpy(
        {k: np.asarray(x) for k, x in bgj._asdict().items() if x is not None},
        device="cpu")
    return bgj, bgt


def states(n=900, seed=11):
    """(5, n) states over the band and past it, |ky| past the RHS's mask
    on a few percent (a stage flag freezes the lane), NaN lon, ky and amp
    rows; per-lane times over, between and past the frames."""
    rng = np.random.default_rng(seed)
    y = np.stack([rng.uniform(-1.0, 7.3, n), rng.uniform(-1.6, 1.6, n),
                  rng.uniform(0.5, 7.5, n), rng.normal(0.0, 40.0, n),
                  rng.uniform(0.5, 2.0, n)])
    for row, sl in ((0, np.s_[:10]), (3, np.s_[10:20]), (4, np.s_[20:30])):
        y[row, sl] = np.nan
    y[1, 30:40] = np.pi / 2 - 1e-3
    t0 = (rng.integers(-1, 4, n) * DT).astype(np.float64)
    return y, t0


def same(a, b):
    return bool(torch.equal(torch.isnan(a), torch.isnan(b))
                and torch.equal(torch.nan_to_num(a), torch.nan_to_num(b)))


@pytest.mark.parametrize("frames", [False, True], ids=["static", "frames"])
@pytest.mark.parametrize("prec", list(PRECISIONS))
def test_step_rays_equals_rk4_step(jet_field, prec, frames):
    """The plain route bitwise ``rk4_step`` over ``ray.rhs``, the freeze of
    a flagged lane included, and within the step bar of the JAX package's
    ``rk4_step`` on the same state and per-lane times (op by op,
    ``jax.disable_jit``, as tests/test_torch_mixed.py holds steps)."""
    cal, state = PRECISIONS[prec]
    bgj, bgt = backgrounds(jet_field, cal, frames)
    y, t0 = (x.astype(state) for x in states())
    yt, tt = torch.as_tensor(y), torch.as_tensor(t0)
    out = trk4.rk4_step_rays(bgt, yt, DT, tt)
    assert out.dtype == yt.dtype and out.shape == yt.shape
    assert same(out, trk4.rk4_step(bgt, yt, DT, tt, rhs=tray.rhs))
    frozen = ~torch.isnan(yt).any(0) & (out == yt).all(0)
    assert int(frozen.sum()) > 0
    with jax.disable_jit():
        ref = np.asarray(jrk4.rk4_step(bgj, jnp.asarray(y), jnp.asarray(
            DT, state), jnp.asarray(t0)))
    got = out.numpy()
    np.testing.assert_array_equal(np.isnan(ref), np.isnan(got))
    scale = np.nanmax(np.abs(ref), axis=1, keepdims=True)
    err = np.nan_to_num(np.abs(ref - got)) / scale
    bar = STEP_BAR if prec == "float64" else STEP_BAR32
    assert err.max() <= bar, err.max()


@pytest.mark.parametrize("case", ["float64", "float32", "mixed", "frames"])
def test_rk4_cause_counts_equal_jax(critical_line_field, case):
    """The critical-line workload in RK4, traced by the JAX package in
    float64, float32, mixed precision (a float64 state over the float32
    field; the re-run takes the field's dtype in both packages) and over
    daily frames of the field (float64, the time instance), classified by
    both packages on the same state: the same cause counts, the re-run's
    state the plain ``rk4_step``'s."""
    u, v, lat, lon = critical_line_field
    cal = "float64" if case in ("float64", "frames") else "float32"
    cfg = dict(CFG, **RUNS["rk4"], cal_dtype=cal)
    if case == "mixed":
        cfg["state_dtype"] = "float64"
    if case == "frames":
        bs = jprepare_tv(*frames_of(u, v, 13), lat, lon, bg_t0=0.0,
                         bg_dt=DAY, cal_dtype=cal)
    else:
        bs = rt.prepare(u, v, lat, lon, cal_dtype=cal)
    jcfg = rt.RunConfig(**cfg)
    traj = rt.trace_rays(bs, jcfg)
    pbs = convert.basic_state_from_numpy(
        {k: np.asarray(x) for k, x in bs._asdict().items()}, device="cpu")
    ptraj = convert.trajectories_from_numpy(
        {k: np.asarray(x) for k, x in traj._asdict().items()}, device="cpu")
    pcfg = pt.RunConfig(**cfg)
    want = jterm.classify(traj, bs, jcfg)
    got = pterm.classify(ptraj, pbs, pcfg)
    assert got.counts == want.counts
    assert sum(got.counts[c] for c in CAUSES) > 0
    death = pterm.analyze(ptraj).death_step
    st, sp = {}, {}
    a = pterm.cause_labels(ptraj, pbs, pcfg, death, stats=st)
    b = pterm.cause_labels(ptraj, pbs, pcfg, death, rhs=tray.rhs, stats=sp)
    np.testing.assert_array_equal(a, b)
    assert same(st["state"], sp["state"])


#: The step kernel's and the RHS kernel's (state, field, variant) keys.
STEP_KEYS = [(state, field, variant)
             for state, field in ((torch.float32, torch.float32),
                                  (torch.float64, torch.float64),
                                  (torch.float64, torch.float32))
             for variant in ("", "_time")]


@pytest.mark.parametrize("key", STEP_KEYS)
@pytest.mark.parametrize("which", ["rk4_step", "rhs"])
def test_instance_window(monkeypatch, key, which):
    """``rk4.step_instance`` and ``ray.rhs_instance`` take the team exactly
    in their variant's window (``kernels.RK4_STEP_TEAM_LANES``,
    ``kernels.RHS_TEAM_LANES``), capped by the card's resident count (here
    stand-ins: one that caps nothing, one below the window's top). The RHS
    kernel runs in the background's dtype."""
    dtypes, variant = key[:2], key[2]
    if which == "rhs" and dtypes[0] != dtypes[1]:
        dtypes = dtypes[1]
    window = (kernels.RK4_STEP_TEAM_LANES if which == "rk4_step"
              else kernels.RHS_TEAM_LANES)
    choose = trk4.step_instance if which == "rk4_step" else tray.rhs_instance
    lo, hi = window[variant]
    for resident, top in ((8 * (hi + 100), hi), (8 * (hi - 7), hi - 7)):
        seen = []

        def fake(kernel, inst, dtype, *a, _r=resident, **k):
            seen.append(kernel)
            return _r

        monkeypatch.setattr(kernels, "resident", fake)
        for r, want in ((lo - 1, "lane"), (lo, kernels.TEAM),
                        (top, kernels.TEAM), (top + 1, "lane")):
            assert choose(r, dtypes, variant) == want, (r, top)
        assert set(seen) == {which}


def test_cpu_step_launches_nothing(jet_field):
    """On a CPU state the step is the plain one: no kernel launch."""
    _, bgt = backgrounds(jet_field, "float64", False)
    y, t0 = states(64)
    before = (trk4.STEP_LAUNCHES, tray.LAUNCHES)
    trk4.rk4_step_rays(bgt, torch.as_tensor(y), DT, torch.as_tensor(t0))
    assert (trk4.STEP_LAUNCHES, tray.LAUNCHES) == before
