"""Port parity: ``trace_rays_ensemble`` against the JAX package's.

Members are the conftest's ``jet_field`` scaled (0.8, 1.0, 1.2), static or
time-varying (3 frames 1.5 days apart, the jet's amplitude varying and its
wave drifting), float64, 2 x 2 sources x zwn (2, 4), 3 days of 2 h steps;
the JAX states are carried across with ``convert``.

Bars: against the JAX package's ensemble, NaN masks identical at every
step and values within 1e-10 in rk4 (the port's rk4 bar on time-varying
states, ``test_torch_time_varying.py``) and within 1e-6 in rk45 (the bar
the JAX package holds its own ensemble to against its separate runs,
``tests/test_ensemble_rk45.py``). Against the port's own ``trace_rays`` of
each member: bitwise (float64 on the CPU: a lane's rows do not depend on
the other lanes, here the other members' and the compacted rootless ones).
"""

import numpy as np
import pytest
import torch

import rwrt_tpu as rt
from rwrt_tpu.models.basic_state import prepare_time_varying as jprepare_tv
from rwrt_tpu.tracer import trace_rays_ensemble as jensemble
import rwrt_tpu_torch as pt
from rwrt_tpu_torch import convert

DAY = 86400.0
CFG = dict(zwn=(2.0, 4.0), sw_lon=0.0, sw_lat=10.0, dlon=90.0, dlat=10.0,
           nnx=2, nny=2, tstep=7200.0, ttotal=3 * DAY, cal_dtype="float64")
SCALES = (0.8, 1.0, 1.2)


def to_port(bs):
    return convert.basic_state_from_numpy(
        {k: np.asarray(x) for k, x in bs._asdict().items()}, device="cpu")


@pytest.fixture(scope="module")
def members(jet_field):
    """Per kind ("static", "varying"): the JAX members and the port's."""
    u, v, lat, lon = jet_field
    out = {}
    static = [rt.prepare(s * u, v, lat, lon, cal_dtype="float64")
              for s in SCALES]
    varying = [jprepare_tv(
        np.stack([s * (1.0 + 0.3 * np.sin(1.3 * k)) * u for k in range(3)]),
        np.stack([np.roll(v, 3 * k, axis=0) for k in range(3)]), lat, lon,
        bg_t0=-0.5 * DAY, bg_dt=1.5 * DAY, cal_dtype="float64")
        for s in SCALES]
    for kind, ms in (("static", static), ("varying", varying)):
        out[kind] = ms, [to_port(m) for m in ms]
    return out


CASES = {"rk4": dict(integrator="rk4"),
         "rk45_batch1": dict(integrator="rk45", interval_batch=1),
         "rk45_batch16": dict(integrator="rk45", interval_batch=16)}


@pytest.mark.parametrize("kind", ["static", "varying"])
@pytest.mark.parametrize("case", list(CASES))
def test_ensemble_matches_jax_and_own_runs(members, case, kind):
    jm, tm = members[kind]
    cfg = dict(CFG, **CASES[case])
    ref = jensemble(jm, rt.RunConfig(**cfg))
    out = pt.trace_rays_ensemble(tm, pt.RunConfig(**cfg))
    assert len(out) == len(SCALES)
    atol = 1e-10 if case == "rk4" else 1e-6
    for r, o, m in zip(ref, out, tm):
        for k in r._fields:
            a, b = np.asarray(getattr(r, k)), getattr(o, k).numpy()
            assert a.shape == b.shape == (37, 3, 4, 2), k
            np.testing.assert_array_equal(np.isnan(a), np.isnan(b),
                                          err_msg=k)
            np.testing.assert_allclose(a, b, rtol=0, atol=atol,
                                       equal_nan=True, err_msg=k)
        own = pt.trace_rays(m, pt.RunConfig(**cfg))
        for k in own._fields:
            x, y = getattr(own, k), getattr(o, k)
            assert torch.equal(torch.isnan(x), torch.isnan(y)), k
            assert torch.equal(torch.nan_to_num(x), torch.nan_to_num(y)), k
    # The members differ: the ensemble is not one member three times.
    assert not np.allclose(out[0].lat.numpy(), out[2].lat.numpy(),
                           equal_nan=True)


def test_ensemble_runs_in_the_fields_dtype(members):
    """``state_dtype`` is not read, as in the JAX package: a float32
    ensemble gives float32 rows whatever the config says."""
    jm, _ = members["static"]
    tm32 = [convert.basic_state_from_numpy(
        {k: np.asarray(x) for k, x in m._asdict().items()}, device="cpu",
        dtype="float32") for m in jm]
    cfg = pt.RunConfig(**dict(CFG, integrator="rk4", cal_dtype="float32",
                              state_dtype="float64"))
    out = pt.trace_rays_ensemble(tm32[:2], cfg)
    assert all(getattr(o, k).dtype == torch.float32
               for o in out for k in o._fields)


def test_ensemble_refuses_mismatched_members(members):
    _, tm = members["varying"]
    cfg = pt.RunConfig(**CFG)
    shifted = tm[1]._replace(bg_t0=tm[1].bg_t0 + 1.0)
    with pytest.raises(ValueError, match="time metadata"):
        pt.trace_rays_ensemble([tm[0], shifted], cfg)
    with pytest.raises(ValueError):
        pt.trace_rays_ensemble([tm[0], tm[1]._replace(
            fields=tm[1].fields[:2])], cfg)
    with pytest.raises(ValueError):
        pt.trace_rays_ensemble([tm[0], members["static"][1][0]], cfg)
    with pytest.raises(TypeError, match="Mesh"):
        pt.trace_rays_ensemble(tm, cfg, mesh=object())
