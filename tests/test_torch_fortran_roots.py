"""root_order='fortran' in the port against the JAX package.

``ops.cubic.fortran_slot_order`` bitwise against JAX's on seeded (..., 3)
arrays with every root count and NaNs; ``initial_roots_reference_order``
(np.roots on the host) with the same slots and NaN mask, values within
1e-10; ``trace_rays`` in RK4 (every output within 1e-10 of its largest
magnitude, NaN masks identical) and in rk45 dense (identical masks, lon/lat
RMSE under 0.1 degree, tests/test_torch_trace.py's bars); the chunked driver
and a two-member ensemble in fortran order; the host root backends.
"""

import numpy as np
import pytest
import torch

import rwrt_tpu as rt
import rwrt_tpu_torch as pt
from rwrt_tpu.ops import cubic as jcubic
from rwrt_tpu.ops import cubic_host as jhost
from rwrt_tpu_torch import convert
from rwrt_tpu_torch.ops import cubic as pcubic
from rwrt_tpu_torch.ops import cubic_host as phost

DAY = 86400.0
CFG = dict(zwn=(1.0, 2.0, 4.0, 6.0), sw_lon=0.0, sw_lat=-40.0, dlon=45.0,
           dlat=20.0, nnx=4, nny=5, tstep=7200.0, ttotal=2 * DAY,
           cal_dtype="float64", root_order="fortran")


@pytest.fixture(scope="module")
def states(jet_field):
    u, v, lat, lon = jet_field
    bsj = rt.prepare(u, v, lat, lon, cal_dtype="float64")
    bsp = convert.basic_state_from_numpy(
        {k: np.asarray(x) for k, x in bsj._asdict().items()}, device="cpu")
    return bsj, bsp


def seeded_roots(count, n=4096, seed=0):
    """(n, 3) roots with ``count`` finite slots in random places (random
    signs and zeros among them), and the counts."""
    rng = np.random.default_rng(seed + count)
    r = rng.normal(scale=20.0, size=(n, 3))
    r[rng.random((n, 3)) < 0.05] = 0.0
    keep = np.argsort(rng.random((n, 3)), axis=1) < count
    r = np.where(keep, r, np.nan)
    return r, np.full(n, count, np.int32)


@pytest.mark.parametrize("count", [0, 1, 2, 3])
def test_fortran_slot_order_bitwise(count):
    r, c = seeded_roots(count)
    ref = np.asarray(jcubic.fortran_slot_order(r, c))
    got = pcubic.fortran_slot_order(torch.as_tensor(r),
                                    torch.as_tensor(c)).numpy()
    np.testing.assert_array_equal(np.isnan(ref), np.isnan(got))
    assert np.array_equal(np.nan_to_num(ref), np.nan_to_num(got))


def test_initial_roots_reference_order_matches_jax(states):
    """The host solve on the sources' Mercator background: the same slots
    and NaN mask as JAX's, values within 1e-10."""
    from rwrt_tpu_torch.models import ray
    from rwrt_tpu_torch.ops import interp
    from rwrt_tpu_torch.tracer import make_background

    _, bsp = states
    cfg = pt.RunConfig(**dict(CFG, nnx=12, nny=8, dlon=30.0, dlat=10.0,
                              sw_lat=-70.0))
    slon, slat = (torch.as_tensor(x) for x in pt.source_matrix(
        cfg.sw_lon, cfg.sw_lat, cfg.dlon, cfg.dlat, cfg.nnx, cfg.nny))
    f = ray.sample_bg(make_background(bsp, 0.0), slon, slat)
    fm = [f[i].numpy() for i in (interp.M_U, interp.M_V, interp.M_QX,
                                 interp.M_QY)]
    zwn = cfg.zwn_array()
    ref = jhost.initial_roots_reference_order(*fm, 0.0, zwn)
    got = phost.initial_roots_reference_order(
        *(torch.as_tensor(x) for x in fm), 0.0, torch.as_tensor(zwn))
    assert got.shape == (96, 4, 3)
    np.testing.assert_array_equal(np.isnan(ref), np.isnan(got))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-10)
    # Every count from 1 to 3 occurs, and the layout is not canonical.
    counts = np.isfinite(got).sum(-1)
    assert set(np.unique(counts)) >= {1, 2, 3}
    canon, _ = pcubic.solve_dispersion_cubic(
        *(torch.as_tensor(x)[:, None] for x in fm), 0.0,
        torch.as_tensor(zwn)[None, :])
    canon = canon.numpy()
    np.testing.assert_allclose(np.sort(got, -1), np.sort(canon, -1),
                               rtol=1e-9, atol=1e-9)
    assert not np.array_equal(np.nan_to_num(got), np.nan_to_num(canon))


def to_numpy(traj):
    return {k: np.asarray(getattr(traj, k)) for k in traj._fields}


def assert_rk4_close(ref, got):
    for k in ref:
        a, b = ref[k], got[k]
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=k)
        np.testing.assert_allclose(b, a, rtol=0,
                                   atol=1e-10 * np.nanmax(np.abs(a)),
                                   err_msg=k)


def assert_rk45_close(ref, got):
    for k in ref:
        np.testing.assert_array_equal(np.isnan(ref[k]), np.isnan(got[k]),
                                      err_msg=k)
    la, lb = ref["lat"], got["lat"]
    dlon = (ref["lon"] - got["lon"] + np.pi) % (2 * np.pi) - np.pi
    both = np.isfinite(la) & np.isfinite(lb)
    assert both.any()
    err = np.degrees(np.concatenate([(dlon * np.cos(la))[both],
                                     (la - lb)[both]]))
    assert np.sqrt(np.mean(err ** 2) * 2) < 0.1


@pytest.mark.parametrize("branch", ["rk4", "dense"])
def test_trace_rays_fortran_matches_jax(states, branch):
    bsj, bsp = states
    cfg = dict(CFG)
    if branch == "dense":
        cfg.update(integrator="rk45", bound_mode="dense", interval_batch=8,
                   pin_limit=500, pin_mwn=0.0)
    ref = to_numpy(rt.trace_rays(bsj, rt.RunConfig(**cfg)))
    got = to_numpy(pt.trace_rays(bsp, pt.RunConfig(**cfg)))
    (assert_rk4_close if branch == "rk4" else assert_rk45_close)(ref, got)
    # Row 0 is the seed: the fortran slots exactly as JAX's within 1e-10.
    np.testing.assert_allclose(got["ky"][0], ref["ky"][0], rtol=0,
                               atol=1e-10)
    canon = pt.trace_rays(bsp, pt.RunConfig(**dict(
        cfg, root_order="canonical")))
    assert not np.array_equal(np.nan_to_num(got["ky"][0]),
                              np.nan_to_num(canon.ky[0].numpy()))


def test_chunked_fortran_equals_trace_rays(states):
    """The chunked driver seeds the same fortran slots; in float64 its
    rows are trace_rays' bit for bit (chunk_steps = interval_batch)."""
    _, bsp = states
    cfg = pt.RunConfig(**dict(CFG, integrator="rk45", interval_batch=8))
    a = pt.trace_rays(bsp, cfg)
    b = pt.trace_rays_chunked(bsp, cfg, chunk_steps=8, verbose=False)
    for k in a._fields:
        assert torch.equal(getattr(a, k).nan_to_num(),
                           getattr(b, k).nan_to_num()), k


def test_ensemble_fortran_two_members(jet_field):
    """A two-member trace_rays_ensemble in fortran order: each member
    against the JAX ensemble's (RK4 bar) and its own trace_rays, bitwise."""
    u, v, lat, lon = jet_field
    us = [u, 1.2 * u]
    jm = [rt.prepare(x, v, lat, lon, cal_dtype="float64") for x in us]
    pm = [pt.prepare(x, v, lat, lon, cal_dtype="float64", device="cpu")
          for x in us]
    ref = rt.trace_rays_ensemble(jm, rt.RunConfig(**CFG))
    got = pt.trace_rays_ensemble(pm, pt.RunConfig(**CFG))
    for r, g, m in zip(ref, got, pm):
        assert_rk4_close(to_numpy(r), to_numpy(g))
        own = pt.trace_rays(m, pt.RunConfig(**CFG))
        for k in own._fields:
            assert torch.equal(getattr(own, k).nan_to_num(),
                               getattr(g, k).nan_to_num()), k


def test_host_root_backends():
    """roots_native (built into rwrt_tpu_torch/_build/ at first use) and
    roots_numpy give the JAX package's roots; the dispatch refuses an
    unknown backend."""
    from rwrt_tpu_torch.native import build

    rng = np.random.default_rng(3)
    coeffs = rng.normal(size=(64, 4)) + 1j * rng.normal(size=(64, 4))
    ref = jhost.roots_numpy(coeffs)
    np.testing.assert_array_equal(phost.roots_numpy(coeffs), ref)
    got = phost.solve_roots(coeffs, "native")
    assert build.library_path().parent.name == "_build"
    assert build.library_path().parent.parent.name == "rwrt_tpu_torch"
    for a, b in zip(ref, got):
        for root in a:
            assert np.min(np.abs(b - root)) < 1e-8 * max(1.0, abs(root))
    with pytest.raises(ValueError, match="backend"):
        phost.solve_roots(coeffs, "fortran")
