"""The device mesh: ``rwrt_tpu_torch/parallel/sharding.py`` and the mesh
paths of ``trace_rays``, ``trace_rays_ensemble``, the chunked driver,
``compute_wavenumber_maps`` and ``main.run``, against the port's own runs
without a mesh and the JAX package's runs on ``make_mesh(8)``, the
conftest's 8 virtual CPU devices.

The port's mesh here is ``Mesh((cpu,) * 8)``: eight shards run one after
another on the CPU, the port's form of JAX's virtual devices; where the
padding or the compaction's rounding needs a size that does not divide the
lanes, a mesh of 3.

Inputs: the conftest's ``jet_field`` (the JAX package's prepared state,
float64, and float32 for mixed precision, carried across with
``convert``), a 5 x 4 source grid x zwn 2, 4, 6: 180 rays, 54 rootless,
128 lanes after compaction; 3 days of 2 h steps. Ensembles: three members
(the jet scaled 0.8, 1.0, 1.2) over 5 x 1 sources x zwn 2 without rootless
compaction: 45 lanes, which 8 does not divide.

Bars.

- Against the port's run without a mesh: bitwise (all seven outputs, NaN
  masks, ``lane_att`` and the truncation count), every branch, every mesh
  size. A lane's rows do not depend on the other lanes: on the CPU the
  plain versions run pow and atan2 in whole vector trips
  (``ops.interp.lane_op``), whose tail would otherwise round by the
  batch's width.
- Against the JAX package's mesh runs: NaN masks identical at every step
  for all seven outputs. RK4: within 3e-13 of each row's scale
  (tests/test_torch_rk4.py's 10-day bar). Adaptive runs: every lane's
  largest position difference within twice the JAX package's own largest
  spread, read in the same test: its single-device run against itself with
  the source longitudes moved one ulp (the bar of tests/test_torch_trace.py
  and test_torch_mixed.py), and against its mesh run (XLA vectorizes a
  shard's lane count differently: tests/test_shardmap.py).
- Ensembles: within 1e-6 (tests/test_torch_ensemble.py's rk45 bar).
  Wavenumber maps: within 1e-10 of each output's largest magnitude
  (tests/test_torch_shsf_wavenumber.py's).
"""

import json

import numpy as np
import pytest
import torch

import rwrt_tpu as rt
import rwrt_tpu_torch as pt
from rwrt_tpu import tracer as jtracer
from rwrt_tpu.diagnostics import wavenumber as jwn
from rwrt_tpu.main import RunPaths as JPaths
from rwrt_tpu.main import run as jax_run
from rwrt_tpu.models.basic_state import prepare_time_varying as jprepare_tv
from rwrt_tpu.parallel import sharding as jsh
from rwrt_tpu.utils.checkpoint import trace_rays_chunked as jchunked
from rwrt_tpu_torch import convert
from rwrt_tpu_torch import main as pmain
from rwrt_tpu_torch.diagnostics import wavenumber as pwn
from rwrt_tpu_torch.models.ray import Background
from rwrt_tpu_torch.parallel import sharding as sh
from rwrt_tpu_torch.utils import checkpoint as ck

DAY = 86400.0
CFG = dict(zwn=(2.0, 4.0, 6.0), sw_lon=0.0, sw_lat=5.0, dlon=36.0, dlat=8.0,
           nnx=5, nny=4, tstep=7200.0, ttotal=3 * DAY, cal_dtype="float64")
BRANCHES = {
    "rk4": dict(integrator="rk4"),
    "exact": dict(integrator="rk45", interval_batch=16),
    "barrier": dict(integrator="rk45", interval_batch=1),
    "dense_pin": dict(integrator="rk45", bound_mode="dense",
                      interval_batch=16, pin_limit=500, pin_mwn=0.0),
    "mixed": dict(integrator="rk45", bound_mode="dense", interval_batch=16,
                  cal_dtype="float32", state_dtype="float64"),
}
#: The tight cut-off at which most born rays die within days, so that the
#: chunked driver's dead-lane compaction engages (tests/test_torch_chunked.py).
TIGHT = dict(cut_off=0.01)
RK4_BAR = 3e-13
ENSEMBLE_BAR = 1e-6
MAPS_BAR = 1e-10
CPU8 = sh.Mesh((torch.device("cpu"),) * 8)
CPU3 = sh.Mesh((torch.device("cpu"),) * 3)


def to_port(bs):
    return convert.basic_state_from_numpy(
        {k: np.asarray(x) for k, x in bs._asdict().items()}, device="cpu")


@pytest.fixture(scope="module")
def states(jet_field):
    """Per cal_dtype: the JAX package's prepared state and the port's copy."""
    u, v, lat, lon = jet_field
    out = {}
    for dtype in ("float64", "float32"):
        bsj = rt.prepare(u, v, lat, lon, cal_dtype=dtype)
        out[dtype] = bsj, to_port(bsj)
    return out


def assert_bitwise(a, b, what=""):
    for k in a._fields:
        x, y = getattr(a, k), getattr(b, k)
        assert x.dtype == y.dtype and x.shape == y.shape, (what, k)
        assert x.device == y.device, (what, k)
        assert torch.equal(torch.isnan(x), torch.isnan(y)), (what, k)
        assert torch.equal(torch.nan_to_num(x), torch.nan_to_num(y)), (what,
                                                                        k)


def per_lane_diff(a, b):
    """max over output steps of max(|dlon|, |dlat|) in rad, per live lane."""
    la, lb = np.asarray(a.lat), np.asarray(b.lat)
    dlon = np.asarray(a.lon) - np.asarray(b.lon)
    dlon = (dlon + np.pi) % (2 * np.pi) - np.pi
    d = np.nanmax(np.maximum(np.abs(dlon), np.abs(la - lb)), axis=0)
    return d[np.isfinite(d)]


def assert_masks(ref, out):
    for name in ref._fields:
        a, b = np.asarray(getattr(ref, name)), getattr(out, name).numpy()
        assert a.shape == b.shape, name
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b), name)


def assert_rk4_close(ref, out):
    """RK4_BAR of each row's scale, every output."""
    for name in ref._fields:
        a, b = np.asarray(getattr(ref, name)), getattr(out, name).numpy()
        scale = np.nanmax(np.abs(a), axis=tuple(range(1, a.ndim)),
                          keepdims=True)
        d = np.nan_to_num(np.abs(a - b)) / np.where(scale > 0, scale, 1.0)
        assert d.max() <= RK4_BAR, (name, d.max())


def sources(cfg, dtype):
    return tuple(np.asarray(x, dtype) for x in jtracer.source_matrix(
        cfg.sw_lon, cfg.sw_lat, cfg.dlon, cfg.dlat, cfg.nnx, cfg.nny))


def own_spread(run, bs, cfg, meshed):
    """The JAX package's own largest per-lane difference: its single-device
    run (``run`` a JAX driver) against itself with the source longitudes
    and latitudes each moved by one ulp of the background's dtype, both
    ways (tests/test_torch_time_varying.py's ``jax_spread``), and against
    its mesh run ``meshed``."""
    dtype = np.asarray(bs.fields).dtype
    slon, slat = sources(cfg, dtype)
    single = run(bs, cfg, source_lon=slon, source_lat=slat)
    inf = dtype.type(np.inf)
    moves = [(np.nextafter(slon, s * inf), slat) for s in (1, -1)]
    moves += [(slon, np.nextafter(slat, s * inf)) for s in (1, -1)]
    return max([per_lane_diff(single, meshed).max()]
               + [per_lane_diff(single, run(bs, cfg, source_lon=lo,
                                            source_lat=la)).max()
                  for lo, la in moves])


@pytest.fixture(scope="module")
def runs(states):
    """Per branch, lazily: the JAX package's mesh run and (adaptive
    branches) its own spread, and the port's runs without and with the
    mesh (and their stats), all from the same sources in the background's
    dtype."""
    cache = {}

    def get(branch):
        if branch not in cache:
            cfg = dict(CFG, **BRANCHES[branch])
            bsj, bst = states[cfg["cal_dtype"]]
            jc, tc = rt.RunConfig(**cfg), pt.RunConfig(**cfg)
            src = dict(zip(("source_lon", "source_lat"), sources(
                jc, np.asarray(bsj.fields).dtype)))
            meshed = rt.trace_rays(bsj, jc, mesh=jsh.make_mesh(8), **src)
            spread = (None if branch == "rk4"
                      else own_spread(rt.trace_rays, bsj, jc, meshed))
            s0, s8 = {}, {}
            own = pt.trace_rays(bst, tc, stats=s0, **src)
            out = pt.trace_rays(bst, tc, mesh=CPU8, stats=s8, **src)
            cache[branch] = (meshed, spread), (own, s0), (out, s8)
        return cache[branch]

    return get


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_trace_rays_under_mesh_bitwise_own_run(runs, branch):
    """rk4, exact (interval_batch 16 and 1), dense with pin and mixed
    precision: the mesh run is the run without it, bit for bit, its
    attempts too; its per-shard attempts are each shard's."""
    _, (own, s0), (out, s8) = runs(branch)
    assert_bitwise(own, out, branch)
    if branch == "rk4":
        assert not s0 and not s8
        return
    assert torch.equal(s0["lane_att"], s8["lane_att"])
    n_groups = s0["lane_att"].shape[0]
    assert tuple(s8["shard_iters"].shape) == (8, n_groups)
    w = s0["lane_att"].shape[1] // 8
    per_shard = s0["lane_att"].reshape(n_groups, 8, w).amax(dim=2).T
    assert torch.equal(s8["shard_iters"].to(per_shard.dtype), per_shard)


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_trace_rays_under_mesh_matches_jax_mesh(runs, branch):
    """Against the JAX package's run on make_mesh(8): NaN masks identical,
    values within the file's bars."""
    (meshed, spread), _, (out, _) = runs(branch)
    assert_masks(meshed, out)
    if branch == "rk4":
        assert_rk4_close(meshed, out)
        return
    d = per_lane_diff(meshed, out)
    assert d.size > 0 and d.max() <= 2 * spread, (d.max(), spread)
    if branch == "mixed":
        assert all(getattr(out, k).dtype == torch.float64
                   for k in out._fields)


def test_per_shard_attempts_differ(runs):
    """The counterpart of tests/test_shardmap.py's per-shard loop counts:
    each shard's most attempts per group, and their totals differ between
    shards (the shards stop when their own lanes finish)."""
    _, _, (_, s8) = runs("exact")
    totals = s8["shard_iters"].sum(dim=1)
    assert totals.shape == (8,)
    assert len(set(totals.tolist())) > 1, totals


def test_time_varying_under_mesh(jet_field):
    """A time-varying background (two frames, the jet scaled 1.3 from the
    first to the second, 2 days apart) through the mesh: bitwise the run
    without it, within the bars of the JAX package's mesh run."""
    u, v, lat, lon = jet_field
    bsj = jprepare_tv(np.stack([u, 1.3 * u]), np.stack([v, v]), lat, lon,
                      bg_t0=0.0, bg_dt=2 * DAY, cal_dtype="float64")
    bst = to_port(bsj)
    cfg = dict(CFG, integrator="rk45")
    jc, tc = rt.RunConfig(**cfg), pt.RunConfig(**cfg)
    meshed = rt.trace_rays(bsj, jc, mesh=jsh.make_mesh(8))
    own, out = (pt.trace_rays(bst, tc, mesh=m) for m in (None, CPU8))
    assert_bitwise(own, out)
    assert_masks(meshed, out)
    d = per_lane_diff(meshed, out)
    assert d.max() <= 2 * own_spread(rt.trace_rays, bsj, jc, meshed)


def test_ensemble_under_mesh(jet_field):
    """Three members, 45 flattened lanes (8 does not divide them: three
    pad lanes of member 0): each member bitwise its meshless ensemble
    member, attempts too, and within ENSEMBLE_BAR of the JAX package's
    ensemble on make_mesh(8)."""
    u, v, lat, lon = jet_field
    jm = [rt.prepare(s * u, v, lat, lon, cal_dtype="float64")
          for s in (0.8, 1.0, 1.2)]
    tm = [to_port(m) for m in jm]
    cfg = dict(CFG, zwn=(2.0,), nny=1, integrator="rk45",
               compact_rootless=False)
    s0, s8 = {}, {}
    own = pt.trace_rays_ensemble(tm, pt.RunConfig(**cfg), stats=s0)
    out = pt.trace_rays_ensemble(tm, pt.RunConfig(**cfg), mesh=CPU8,
                                 stats=s8)
    assert s0["lane_att"].shape[1] == 45
    assert torch.equal(s0["lane_att"], s8["lane_att"])
    ref = rt.trace_rays_ensemble(jm, rt.RunConfig(**cfg),
                                 mesh=jsh.make_mesh(8))
    for r, a, b in zip(ref, own, out):
        assert_bitwise(a, b)
        assert_masks(r, b)
        for k in r._fields:
            np.testing.assert_allclose(getattr(b, k).numpy(),
                                       np.asarray(getattr(r, k)), rtol=0,
                                       atol=ENSEMBLE_BAR, equal_nan=True)


@pytest.mark.parametrize("integrator", ["rk45", "rk4"])
def test_chunked_under_mesh(states, tmp_path, integrator):
    """The chunked driver under the mesh: bitwise its run without it; a run
    cut by a chunk budget with a checkpoint and resumed under the same
    mesh bitwise the uninterrupted one; within the bars of the JAX
    driver's run on make_mesh(8) (compaction on, its widths a multiple of
    8); resuming under a mesh of another size raises."""
    bsj, bst = states["float64"]
    cfg = dict(CFG, integrator=integrator, **TIGHT)
    jc, tc = rt.RunConfig(**cfg), pt.RunConfig(**cfg)
    kw = dict(chunk_steps=8, verbose=False, compact_min_width=8)
    s0, s8 = {}, {}
    own = ck.trace_rays_chunked(bst, tc, stats=s0, **kw)
    out = ck.trace_rays_chunked(bst, tc, mesh=CPU8, stats=s8, **kw)
    assert_bitwise(own, out)
    if integrator == "rk45":
        widths = [a.shape[1] for a in s8["lane_att"]]
        assert all(w % 8 == 0 for w in widths) and widths[-1] < widths[0]
        for a, b in zip(s0["lane_att"], s8["lane_att"]):
            assert torch.equal(a, b)

    path = str(tmp_path / "ck.npz")
    with pytest.raises(ck.ChunkBudgetReached):
        ck.trace_rays_chunked(bst, tc, mesh=CPU8, checkpoint_path=path,
                              max_chunks=2, **kw)
    with pytest.raises(ValueError, match="mesh"):
        ck.trace_rays_chunked(bst, tc, mesh=CPU3, checkpoint_path=path, **kw)
    resumed = ck.trace_rays_chunked(bst, tc, mesh=CPU8, checkpoint_path=path,
                                    **kw)
    assert_bitwise(out, resumed)

    ref = jchunked(bsj, jc, mesh=jsh.make_mesh(8), **kw)
    assert_masks(ref, out)
    if integrator == "rk4":
        assert_rk4_close(ref, out)
        return
    d = per_lane_diff(ref, out)
    assert d.max() <= 2 * own_spread(
        lambda *a, **k: jchunked(*a, **k, **kw), bsj, jc, ref)


def test_chunked_mesh_padding_and_rounded_compaction(states, tmp_path):
    """A mesh of 3 over the 128 compacted lanes: one NaN pad lane (its
    history slot past the rays'), every compacted width a multiple of 3,
    rows bitwise the run without a mesh; a checkpoint written under it
    resumes under it, bitwise, and not without a mesh."""
    _, bst = states["float64"]
    tc = pt.RunConfig(**dict(CFG, integrator="rk45", bound_mode="dense",
                             **TIGHT))
    kw = dict(chunk_steps=8, verbose=False, compact_min_width=8)
    s3 = {}
    own = ck.trace_rays_chunked(bst, tc, **kw)
    out = ck.trace_rays_chunked(bst, tc, mesh=CPU3, stats=s3, **kw)
    assert_bitwise(own, out)
    widths = [a.shape[1] for a in s3["lane_att"]]
    assert widths[0] == 129 and all(w % 3 == 0 for w in widths)
    assert len(set(widths)) > 1
    path = str(tmp_path / "ck3.npz")
    with pytest.raises(ck.ChunkBudgetReached):
        ck.trace_rays_chunked(bst, tc, mesh=CPU3, checkpoint_path=path,
                              max_chunks=1, **kw)
    with pytest.raises(ValueError, match="mesh"):
        ck.trace_rays_chunked(bst, tc, checkpoint_path=path, **kw)
    assert_bitwise(out, ck.trace_rays_chunked(
        bst, tc, mesh=CPU3, checkpoint_path=path, **kw))


def test_rerouted_run_takes_the_mesh(states):
    """``trace_rays`` past auto_chunk_bytes reroutes to the chunked driver
    with its mesh: bitwise the rerouted run without one."""
    _, bst = states["float64"]
    tc = pt.RunConfig(**dict(CFG, **BRANCHES["dense_pin"]))
    s0, s8 = {}, {}
    own = pt.trace_rays(bst, tc, auto_chunk_bytes=1000, stats=s0)
    out = pt.trace_rays(bst, tc, auto_chunk_bytes=1000, mesh=CPU8,
                        stats=s8)
    assert out.lon.device.type == "cpu"
    assert_bitwise(own, out)
    assert len(s8["lane_att"]) == len(s0["lane_att"])


def test_wavenumber_maps_under_mesh():
    """A 46 x 25 grid (1,150 points: 8 does not divide them) under the
    mesh, static and with two frames: bitwise the maps without it, within
    MAPS_BAR of the JAX package's maps on make_mesh(8)."""
    nlon, nlat = 46, 25
    lat = np.linspace(-np.pi / 2, np.pi / 2, nlat)
    lon = np.arange(nlon) * 2 * np.pi / nlon
    u = (22.0 * np.cos(lat)[None, :] ** 2
         + 5.0 * np.cos(2 * lon)[:, None] * np.cos(lat)[None, :])
    v = 2.0 * np.sin(lon)[:, None] * np.cos(lat)[None, :]
    zwn = (2.0, 4.0, 6.0)
    for bsj in (rt.prepare(u, v, lat, lon, cal_dtype="float64"),
                jprepare_tv(np.stack([u, 1.2 * u]), np.stack([v, v]), lat,
                            lon, bg_t0=0.0, bg_dt=DAY, cal_dtype="float64")):
        bst = to_port(bsj)
        ref = jwn.compute_wavenumber_maps(bsj, zwn, mesh=jsh.make_mesh(8))
        own = pwn.compute_wavenumber_maps(bst, zwn)
        out = pwn.compute_wavenumber_maps(bst, zwn, mesh=CPU8)
        for k in own._fields:
            a, b, r = getattr(own, k), getattr(out, k), np.asarray(
                getattr(ref, k))
            assert torch.equal(torch.isnan(a), torch.isnan(b)), k
            assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(b)), k
            assert r.shape == tuple(b.shape), k
            np.testing.assert_array_equal(np.isnan(r), b.isnan().numpy(),
                                          err_msg=k)
            scale = np.nanmax(np.abs(r))
            np.testing.assert_allclose(b.numpy(), r, rtol=0,
                                       atol=MAPS_BAR * scale, err_msg=k)


def test_main_run_with_mesh(tmp_path, jet_field):
    """``main.run(mesh=...)`` (the CLI's --mesh builds one): a Mesh, or True
    over config.mesh_devices entries of the run's device type; the
    trajectory file bitwise the run's without a mesh, the report's "mesh"
    the JAX package's form of it ({"rays": 8} under make_mesh(8))."""
    u, v, lat, lon = jet_field
    inp = str(tmp_path / "wind.npz")
    np.savez(inp, u=u.T, v=v.T, lat=np.degrees(lat), lon=np.degrees(lon))
    cfg = dict(CFG, integrator="rk45", nnx=2, nny=2, ttotal=DAY)
    reports = {}
    for name, run, conf, paths, kw in (
            ("jax", jax_run, rt.RunConfig(**cfg), JPaths,
             dict(mesh=jsh.make_mesh(8))),
            ("plain", pmain.run, pt.RunConfig(**cfg), pmain.RunPaths,
             dict(device="cpu")),
            ("mesh", pmain.run, pt.RunConfig(**cfg), pmain.RunPaths,
             dict(device="cpu", mesh=CPU8)),
            ("true", pmain.run, pt.RunConfig(**cfg, mesh_devices=8),
             pmain.RunPaths, dict(device="cpu", mesh=True))):
        rep = str(tmp_path / f"{name}.json")
        run(conf, paths(inputuv=inp, ncfile=str(tmp_path / f"{name}.npz")),
            verbose=False, report_path=rep, **kw)
        with open(rep) as f:
            reports[name] = json.load(f)["mesh"]
    assert reports["plain"] is None
    assert reports["mesh"] == reports["true"] == reports["jax"] == {"rays": 8}
    with np.load(tmp_path / "plain.npz") as a:
        for name in ("mesh", "true"):
            with np.load(tmp_path / f"{name}.npz") as b:
                assert sorted(a.files) == sorted(b.files)
                for k in a.files:
                    np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    with pytest.raises(TypeError, match="Mesh"):
        pmain.run(pt.RunConfig(**cfg), pmain.RunPaths(inputuv=inp),
                  verbose=False, device="cpu", mesh="rays")


def test_pad_rays_matches_jax():
    """NaN lanes on the trailing axis to a multiple of the shard count, R
    returned, as the JAX package pads; the member map pads with member 0;
    nothing to pad returns the tensor itself."""
    rng = np.random.default_rng(3)
    for shape in ((5, 10), (10,), (3, 2, 13)):
        y = rng.standard_normal(shape)
        ref, r_ref = jsh.pad_rays(np.asarray(y), 8)
        got, r = sh.pad_rays(torch.as_tensor(y), 8)
        assert r == r_ref == shape[-1]
        np.testing.assert_array_equal(np.asarray(ref), got.numpy())
    ids, r = sh.pad_rays(torch.arange(5, dtype=torch.int32), 4)
    assert r == 5 and ids.tolist() == [0, 1, 2, 3, 4, 0, 0, 0]
    y = torch.ones(5, 16)
    assert sh.pad_rays(y, 8)[0] is y


def test_mesh_value_and_helpers():
    """The Mesh value (one axis 'rays', size, repeated entries), shard_rays'
    contiguous slices, replicate's one copy per distinct device, and the
    refusals."""
    m = sh.Mesh([torch.device("cpu")] * 3)
    assert m.axis_names == (sh.RAY_AXIS,) == ("rays",)
    assert m.size == 3 and m.shape == {"rays": 3}
    assert m.device_type == "cpu"
    assert sh.make_mesh(3, "cpu") == m and sh.make_mesh(None, "cpu").size == 1
    y = torch.arange(12.0).reshape(2, 6)
    parts = sh.shard_rays(y, m)
    assert [p.tolist() for p in parts] == [[[0, 1], [6, 7]], [[2, 3], [8, 9]],
                                           [[4, 5], [10, 11]]]
    assert all(p.is_contiguous() for p in parts)
    assert torch.equal(sh.gather_rays(parts, "cpu"), y)
    bg = Background(fields=torch.zeros(2, 2, 48), lon0=0.0,
                              lat0=0.0, dx=1.0, dy=1.0, freq=0.0)
    reps = sh.replicate(bg, m)
    assert len(reps) == 3 and all(r.fields is bg.fields for r in reps)
    with pytest.raises(ValueError, match="split"):
        sh.shard_rays(torch.ones(2, 7), m)
    with pytest.raises(ValueError, match="one device type"):
        sh.Mesh((torch.device("cpu"), torch.device("cuda", 0)))
    with pytest.raises(ValueError, match="axis"):
        sh.Mesh((torch.device("cpu"),), axis_names=("x",))
    with pytest.raises(ValueError):
        sh.Mesh(())
    with pytest.raises(TypeError, match="Mesh"):
        sh.check_mesh(jsh.make_mesh(8), "cpu")
    assert sh.check_mesh(None, "cpu") is None and sh.check_mesh(m, "cpu") is m


def test_make_mesh_refuses_more_cards_than_exist():
    """make_mesh never quietly takes fewer CUDA devices than asked for (the
    JAX package's ``devices[:n]`` would)."""
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(RuntimeError, match="CUDA devices"):
        sh.make_mesh(count + 1)
    if count == 0:
        with pytest.raises(RuntimeError, match="CUDA devices"):
            sh.make_mesh()
    with pytest.raises(ValueError):
        sh.make_mesh(0)
    with pytest.raises(ValueError, match="device type"):
        sh.make_mesh(2, "tpu")
