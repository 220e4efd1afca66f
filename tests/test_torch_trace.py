"""The slice end to end: the port's ``trace_rays`` against rwrt_tpu's.

rk45, bound_mode='dense', interval_batch=16, pin (500, 0), float64, on the
``jet_field`` background carried across with ``convert`` (so the comparison
isolates the tracer from prepare's round-off).

Bars. Alive (NaN) masks identical at every output step. The adaptive
controller amplifies round-off differences between XLA's and PyTorch's
arithmetic chaotically on some lanes (see tests/test_torch_rk45.py). At 4
days the port is held against the JAX package's own spread under a one-ulp
move of the source longitudes, read in the same test: the median lane
within 1e-8 rad, no larger a share of lanes beyond 1e-8 rad than 1.5 times
the JAX package's own share, and every lane within twice its own largest
difference. At 10 days the lon/lat RMSE is held to the 0.1 degree
acceptance gate of BASELINE.md.
"""

import numpy as np
import pytest
import torch

import rwrt_tpu as rt
import rwrt_tpu_torch as pt
from rwrt_tpu import tracer as jtracer
from rwrt_tpu_torch import convert
from rwrt_tpu_torch import tracer as ttracer
from rwrt_tpu_torch.parallel.sharding import Mesh

DAY = 86400.0
CFG = dict(
    zwn=(2.0, 4.0, 6.0), sw_lon=0.0, sw_lat=5.0, dlon=36.0, dlat=8.0,
    nnx=5, nny=4, tstep=7200.0, cal_dtype="float64", integrator="rk45",
    bound_mode="dense", interval_batch=16, pin_limit=500, pin_mwn=0.0,
)


@pytest.fixture(scope="module")
def states(jet_field):
    u, v, lat, lon = jet_field
    bsj = rt.prepare(u, v, lat, lon, cal_dtype="float64")
    bst = convert.basic_state_from_numpy(
        {k: np.asarray(x) for k, x in bsj._asdict().items()},
        device="cpu")
    return bsj, bst


@pytest.fixture(scope="module", params=[4, 10], ids=["4d", "10d"])
def traces(request, states):
    bsj, bst = states
    cfg = dict(CFG, ttotal=request.param * DAY)
    ref = rt.trace_rays(bsj, rt.RunConfig(**cfg))
    out = pt.trace_rays(bst, pt.RunConfig(**cfg))
    return request.param, ref, out


def per_lane_diff(ref, out):
    """max over output steps of max(|dlon|, |dlat|) in rad, per live lane."""
    la, lb = np.asarray(ref.lat), np.asarray(out.lat)
    dlon = np.asarray(ref.lon) - np.asarray(out.lon)
    dlon = (dlon + np.pi) % (2 * np.pi) - np.pi
    d = np.nanmax(np.maximum(np.abs(dlon), np.abs(la - lb)), axis=0)
    return d[np.isfinite(d)]


@pytest.fixture(scope="module")
def jax_ulp_spread_4d(states):
    """The JAX package against itself over 4 days, the source longitudes
    moved by one ulp: per-lane differences."""
    bsj, _ = states
    cfg = rt.RunConfig(**dict(CFG, ttotal=4 * DAY))
    slon, slat = (np.asarray(x) for x in jtracer.source_matrix(
        cfg.sw_lon, cfg.sw_lat, cfg.dlon, cfg.dlat, cfg.nnx, cfg.nny))
    a, b = (rt.trace_rays(bsj, cfg, source_lon=lo, source_lat=slat)
            for lo in (slon, np.nextafter(slon, np.inf)))
    return per_lane_diff(a, b)


def test_alive_masks_identical_at_every_step(traces):
    _, ref, out = traces
    for name in ref._fields:
        a, b = np.asarray(getattr(ref, name)), getattr(out, name).numpy()
        assert a.shape == b.shape, name
        for step in range(a.shape[0]):
            np.testing.assert_array_equal(np.isnan(a[step]), np.isnan(b[step]),
                                          err_msg=f"{name} step {step}")


def test_positions_match_jax(traces, request):
    days, ref, out = traces
    la, lb = np.asarray(ref.lat), out.lat.numpy()
    dlon = np.asarray(ref.lon) - out.lon.numpy()
    dlon = (dlon + np.pi) % (2 * np.pi) - np.pi
    both = np.isfinite(la) & np.isfinite(lb)
    assert both[-1].any()
    if days == 4:
        d = per_lane_diff(ref, out)
        spread = request.getfixturevalue("jax_ulp_spread_4d")
        assert np.median(d) <= 1e-8, np.median(d)
        share, own = np.mean(d > 1e-8), np.mean(spread > 1e-8)
        assert share <= 1.5 * own, (share, own)
        assert d.max() <= 2 * spread.max(), (d.max(), spread.max())
    else:
        err = np.degrees(np.concatenate([(dlon * np.cos(la))[both],
                                         (la - lb)[both]]))
        rmse = np.sqrt(np.mean(err ** 2) * 2)
        assert rmse < 0.1, rmse


def test_convert_round_trip_equals_own_prepare(jet_field):
    """The port's own state, sent through numpy and back, traces the same
    trajectories (within 1e-10; it is in fact bitwise)."""
    u, v, lat, lon = jet_field
    bs = pt.prepare(u, v, lat, lon, cal_dtype="float64", device="cpu")
    back = convert.basic_state_from_numpy(
        {k: (x.numpy() if torch.is_tensor(x) else x)
         for k, x in bs._asdict().items()}, device="cpu")
    cfg = pt.RunConfig(**dict(CFG, ttotal=2 * DAY))
    a, b = pt.trace_rays(bs, cfg), pt.trace_rays(back, cfg)
    for name in a._fields:
        x, y = getattr(a, name).numpy(), getattr(b, name).numpy()
        np.testing.assert_array_equal(np.isnan(x), np.isnan(y))
        np.testing.assert_allclose(x, y, rtol=0, atol=1e-10, err_msg=name)


def test_rootless_lanes_stay_frozen(states):
    _, bst = states
    out = pt.trace_rays(bst, pt.RunConfig(**dict(CFG, ttotal=2 * DAY)))
    rootless = np.isnan(out.ky[0].numpy())
    assert rootless.any()
    lon = out.lon.numpy()
    assert (lon[:, rootless] == lon[0, rootless]).all()
    assert np.isnan(out.ug.numpy()[1:, rootless]).all()
    assert out.lon.shape == (25, 3, 20, 3)


@pytest.mark.parametrize("branch", ["mesh"])
def test_unported_branches_raise(states, branch):
    """Every branch is ported; a ``mesh`` that is not a
    ``parallel.sharding.Mesh`` raises TypeError, and a mesh of CUDA
    entries never runs a CPU state (the mesh's runs:
    tests/test_torch_parallel.py)."""
    _, bst = states
    cfg = pt.RunConfig(**dict(CFG, ttotal=2 * DAY))
    with pytest.raises(TypeError, match="Mesh"):
        pt.trace_rays(bst, cfg, mesh=object())
    with pytest.raises(ValueError, match="cuda"):
        pt.trace_rays(bst, cfg, mesh=Mesh((torch.device("cuda", 0),) * 2))


def test_max_iters_truncation_raises():
    with pytest.raises(ttracer.MaxItersTruncation):
        ttracer._check_truncation(3)
    ttracer._check_truncation(0)
