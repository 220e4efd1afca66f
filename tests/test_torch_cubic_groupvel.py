"""Port parity: dispersion-cubic roots and group velocity.

Roots: the same root sets, slot order and NaN pattern, values within 1e-10
relative (float64). Inputs cover the cubic (three real roots and one), the
degree demotions (fv == 0 and fv tiny), zwn == 0, NaN samples, a nonzero
frequency, and the initialization on a prepared background.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import rwrt_tpu as rt
from rwrt_tpu import tracer as jtracer
from rwrt_tpu.ops import cubic as jcubic
from rwrt_tpu.ops import groupvel as jgv
from rwrt_tpu_torch import convert
from rwrt_tpu_torch import tracer as ttracer
from rwrt_tpu_torch.ops import cubic as tcubic
from rwrt_tpu_torch.ops import groupvel as tgv

TOL = 1e-10


def assert_roots_close(a, b):
    a = np.asarray(a)
    b = b.numpy()
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    fin = np.isfinite(a)
    err = np.abs(a[fin] - b[fin]) / np.maximum(np.abs(a[fin]), 1.0)
    assert err.size == 0 or err.max() <= TOL, err.max()


def samples(kind, n=600):
    rng = np.random.default_rng({"random": 0, "degenerate": 1}[kind])
    fu = rng.normal(10.0, 15.0, n)
    fv = rng.normal(0.0, 3.0, n)
    fqx = rng.normal(0.0, 2.0, n)
    fqy = rng.normal(5.0, 10.0, n)
    zwn = rng.integers(0, 8, n).astype(np.float64)
    if kind == "degenerate":
        fv[:100] = 0.0                 # quadratic
        fv[100:200] = 1e-16            # demoted by the window test
        fv[200:250] = 0.0
        fu[200:250] = 0.0              # linear or empty
        fu[250:260] = np.nan
        fqy[260:270] = np.nan
        zwn[270:300] = 0.0
    return fu, fv, fqx, fqy, zwn


@pytest.mark.parametrize("freq", [0.0, 1e-6])
@pytest.mark.parametrize("kind", ["random", "degenerate"])
def test_solve_dispersion_cubic_matches_jax(kind, freq):
    args = samples(kind)
    ref, ref_n = jcubic.solve_dispersion_cubic(
        *(jnp.asarray(a) for a in args[:4]), freq, jnp.asarray(args[4]))
    out, out_n = tcubic.solve_dispersion_cubic(
        *(torch.as_tensor(a) for a in args[:4]), freq,
        torch.as_tensor(args[4]))
    assert_roots_close(ref, out)
    np.testing.assert_array_equal(np.asarray(ref_n), out_n.numpy())
    # All root counts 0..3 occur in these samples.
    if kind == "degenerate":
        assert set(np.unique(out_n.numpy())) == {0, 1, 2, 3}


def test_canonical_slot_order():
    out, _ = tcubic.solve_dispersion_cubic(
        *(torch.as_tensor(a) for a in samples("random")[:4]), 0.0,
        torch.as_tensor(samples("random")[4]))
    r = out.numpy()
    key = np.where(np.isnan(r), np.inf, np.abs(r) + (r < 0) * 200.0)
    assert (key[:, :-1] <= key[:, 1:]).all()


@pytest.mark.parametrize("zero_invalid", [False, True])
def test_group_velocity_matches_jax(zero_invalid):
    fu, fv, fqx, fqy, zwn = samples("degenerate")
    rng = np.random.default_rng(2)
    mwn = rng.normal(0.0, 5.0, zwn.shape[0])
    mwn[300:320] = np.nan
    zwn[320:330] = np.nan
    ref = jgv.group_velocity(*(jnp.asarray(a) for a in
                               (fu, fv, fqx, fqy, zwn, mwn)),
                             zero_invalid=zero_invalid)
    out = tgv.group_velocity(*(torch.as_tensor(a) for a in
                               (fu, fv, fqx, fqy, zwn, mwn)),
                             zero_invalid=zero_invalid)
    for a, b in zip(ref, out):
        a, b = np.asarray(a), b.numpy()
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        np.testing.assert_allclose(a, b, rtol=1e-13, atol=0)
    zeros = (zwn == 0.0)
    if zero_invalid:
        assert (out[0].numpy()[zeros] == 0).all()


def test_group_velocity_core_masks_are_ieee_sets():
    fu, fv, fqx, fqy, zwn = (torch.as_tensor(a) for a in samples("degenerate"))
    zwn = torch.where(zwn == 0.0, torch.ones_like(zwn), zwn)  # kap finite
    mwn = torch.linspace(-3, 3, fu.shape[0], dtype=torch.float64)
    ug, vg, ug_nan, vg_nan = tgv.group_velocity_core(fu, fv, fqx, fqy, zwn,
                                                     mwn)
    assert torch.isfinite(ug).all() and torch.isfinite(vg).all()
    shared = torch.isnan(fqx) | torch.isnan(fqy) | torch.isnan(zwn)
    assert torch.equal(ug_nan, torch.isnan(fu) | shared)
    assert torch.equal(vg_nan, torch.isnan(fv) | shared)


def test_initialize_matches_jax(jet_field):
    u, v, lat, lon = jet_field
    bs = rt.prepare(u, v, lat, lon, cal_dtype="float64")
    bgj = jtracer.make_background(bs, 0.0)
    bgt = convert.background_from_numpy(
        {k: np.asarray(x) for k, x in bgj._asdict().items()
         if x is not None}, device="cpu")
    slon, slat = jtracer.source_matrix(0.0, -20.0, 24.0, 8.0, 15, 6)
    zwn = np.arange(1.0, 8.0)
    ref = jtracer.initialize(bgj, jnp.asarray(slon), jnp.asarray(slat),
                             jnp.asarray(zwn))
    out = ttracer.initialize(bgt, torch.as_tensor(slon),
                             torch.as_tensor(slat), torch.as_tensor(zwn))
    for a, b in zip(ref, out):
        assert_roots_close(a, b)
    born = np.isfinite(np.asarray(ref[0][4]))
    assert 0 < born.sum() < born.size
    np.testing.assert_array_equal(
        jtracer.compact_lane_indices(born),
        ttracer.compact_lane_indices(born))
