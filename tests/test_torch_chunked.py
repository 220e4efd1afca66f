"""The chunked driver (``rwrt_tpu_torch/utils/checkpoint.py``) against the
JAX package's, against the port's own ``trace_rays``, and through its
checkpoint, budget, stream, early-exit and truncation paths.

The batch: the ``jet_field`` background (float64 carried across from the
JAX package with ``convert``, so the comparison isolates the driver from
prepare's round-off), a 5 x 4 source grid, zwn 2, 4, 6: 180 rays, 54 of
them rootless, 4 days of 2 h steps in chunks of 8.

Bars against the JAX driver (same config, verbose off, float64). NaN masks
identical at every step for all seven outputs. RK4: within 3e-13 of each
row's scale, ``test_torch_rk4.py``'s 10-day bar. RK45: the bars of
``test_torch_trace.py`` against the JAX package's own spread, read here
from the JAX driver against itself with the source longitudes and
latitudes each moved by one ulp: the median lane within 1e-8 rad, no
larger a share of lanes beyond 1e-8 rad than 1.5 times the JAX package's
own, and every lane within twice its own largest difference.

Against the port's ``trace_rays`` with chunk_steps equal to its group, and
in every chain, resume and stream: bitwise. Compaction subsets are held
bitwise in float64 only (in float32 on the CPU a lane subset need not
equal the full batch: ``pow`` and ``atan2`` round by the SIMD layout).
"""

import os

import numpy as np
import pytest
import torch

import rwrt_tpu as rt
from rwrt_tpu import tracer as jtracer
from rwrt_tpu.utils import checkpoint as jck
import rwrt_tpu_torch as pt
from rwrt_tpu_torch import convert
from rwrt_tpu_torch import tracer as ttracer
from rwrt_tpu_torch.utils import checkpoint as ck

DAY = 86400.0
CHUNK = 8
CFG = dict(zwn=(2.0, 4.0, 6.0), sw_lon=0.0, sw_lat=5.0, dlon=36.0,
           dlat=8.0, nnx=5, nny=4, tstep=7200.0, ttotal=4 * DAY,
           cal_dtype="float64")
#: Each branch of the driver. In the JAX driver "dense" and "exact_peel"
#: take peel scheduling (RunConfig's default), "exact_buckets" the
#: difficulty-bucketed chunk and "barrier" the bound-by-bound chunk.
BRANCHES = {
    "rk4": dict(integrator="rk4"),
    "dense": dict(integrator="rk45", bound_mode="dense",
                  interval_batch=CHUNK, pin_limit=500, pin_mwn=0.0),
    "exact_peel": dict(integrator="rk45", interval_batch=CHUNK),
    "exact_buckets": dict(integrator="rk45", interval_batch=CHUNK,
                          difficulty_buckets=2),
    "barrier": dict(integrator="rk45", interval_batch=1),
}
#: The tight cut-off at which most born rays die within days, so that
#: dead-lane compaction engages (tests/test_compact_dead.py).
TIGHT = dict(cut_off=0.01, ttotal=6 * DAY)
RK4_BAR = 3e-13


@pytest.fixture(scope="module")
def states(jet_field):
    u, v, lat, lon = jet_field
    bsj = rt.prepare(u, v, lat, lon, cal_dtype="float64")
    bst = convert.basic_state_from_numpy(
        {k: np.asarray(x) for k, x in bsj._asdict().items()}, device="cpu")
    bs32 = pt.prepare(u, v, lat, lon, cal_dtype="float32", device="cpu")
    return bsj, bst, bs32


def cfg_of(pkg, branch, **changes):
    return pkg.RunConfig(**{**CFG, **BRANCHES[branch], **changes})


def rows(traj):
    """(nt, 7, R) numpy rows of a trajectory of either package."""
    f = [np.asarray(getattr(traj, k)) for k in traj._fields]
    nt = f[0].shape[0]
    return np.stack([x.reshape(nt, -1) for x in f], axis=1)


def assert_bitwise(a, b):
    for k in a._fields:
        x, y = getattr(a, k), getattr(b, k)
        assert x.dtype == y.dtype, k
        assert torch.equal(torch.isnan(x), torch.isnan(y)), k
        assert torch.equal(torch.nan_to_num(x), torch.nan_to_num(y)), k


def assert_masks(ref, out):
    a, b = rows(ref), rows(out)
    assert a.shape == b.shape
    for step in range(a.shape[0]):
        np.testing.assert_array_equal(np.isnan(a[step]), np.isnan(b[step]),
                                      err_msg=f"step {step}")


def per_lane_diff(ref, out):
    """max over steps of max(|dlon|, |dlat|) in rad, per lane live in
    both somewhere."""
    a, b = rows(ref), rows(out)
    dlon = (a[:, 0] - b[:, 0] + np.pi) % (2 * np.pi) - np.pi
    d = np.nanmax(np.maximum(np.abs(dlon), np.abs(a[:, 1] - b[:, 1])),
                  axis=0)
    return d[np.isfinite(d)]


@pytest.fixture(scope="module")
def jax_runs(states):
    """The JAX driver per branch, and per rk45 branch its per-lane spread
    against itself under one-ulp moves of the sources."""
    bsj = states[0]
    out = {}
    for branch in BRANCHES:
        cfg = cfg_of(rt, branch)
        ref = jck.trace_rays_chunked(bsj, cfg, chunk_steps=CHUNK,
                                     verbose=False)
        spread = None
        if branch != "rk4":
            slon, slat = (np.asarray(x) for x in jtracer.source_matrix(
                cfg.sw_lon, cfg.sw_lat, cfg.dlon, cfg.dlat, cfg.nnx,
                cfg.nny))
            spread = np.max([per_lane_diff(ref, jck.trace_rays_chunked(
                bsj, cfg, chunk_steps=CHUNK, verbose=False, source_lon=lo,
                source_lat=la)) for lo, la in (
                    (np.nextafter(slon, np.inf), slat),
                    (slon, np.nextafter(slat, np.inf)))], axis=0)
        out[branch] = ref, spread
    return out


def assert_within_jax_bars(ref, out, spread):
    assert_masks(ref, out)
    if spread is None:
        a, b = rows(ref), rows(out)
        scale = np.nanmax(np.abs(a), axis=(0, 2), keepdims=True)
        d = np.nan_to_num(np.abs(a - b)) / scale
        assert d.max() <= RK4_BAR, d.max()
        return
    d = per_lane_diff(ref, out)
    assert np.median(d) <= 1e-8, np.median(d)
    share, own = np.mean(d > 1e-8), np.mean(spread > 1e-8)
    assert share <= 1.5 * own, (share, own)
    assert d.max() <= 2 * spread.max(), (d.max(), spread.max())


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_matches_jax_driver(states, jax_runs, branch):
    """(a) The same config through both drivers: host tensors of the
    trajectory's shape, NaN masks identical, positions within the bars."""
    _, bst, _ = states
    out = ck.trace_rays_chunked(bst, cfg_of(pt, branch), chunk_steps=CHUNK,
                                verbose=False)
    assert out.lon.shape == (49, 3, 20, 3) and out.lon.device.type == "cpu"
    ref, spread = jax_runs[branch]
    assert_within_jax_bars(ref, out, spread)


@pytest.mark.parametrize("compact", [True, False], ids=["compact", "full"])
@pytest.mark.parametrize("branch", ["rk4", "dense", "exact_peel", "barrier"])
def test_equals_trace_rays_bitwise(states, branch, compact, capsys):
    """(b) With chunk_steps equal to the run's group the chunks are
    ``trace_rays``' groups: the rows are its rows, bit for bit, with
    dead-lane compaction on (it must engage) and off."""
    _, bst, _ = states
    cfg = cfg_of(pt, branch, compact_dead=compact, **TIGHT)
    want = pt.trace_rays(bst, cfg)
    got = ck.trace_rays_chunked(bst, cfg, chunk_steps=CHUNK,
                                verbose=compact, compact_min_width=16)
    if compact:
        out = capsys.readouterr().out
        assert "compacted device batch" in out and "termination" in out
    assert_bitwise(want, got)


@pytest.mark.parametrize("branch", ["rk4", "dense", "exact_peel", "barrier"])
def test_mixed_equals_trace_rays_bitwise(states, branch):
    """(b) In mixed precision (a float64 state over the float32
    background), compaction off: the chunked rows are ``trace_rays``',
    float64, bit for bit."""
    _, _, bs32 = states
    cfg = cfg_of(pt, branch, cal_dtype="float32", state_dtype="float64",
                 compact_dead=False)
    want = pt.trace_rays(bs32, cfg)
    got = ck.trace_rays_chunked(bs32, cfg, chunk_steps=CHUNK, verbose=False)
    assert got.lon.dtype == torch.float64
    assert_bitwise(want, got)


def test_budget_chain_equals_uninterrupted(states, tmp_path):
    """(c) Chained one-chunk attempts through a checkpoint equal the
    uninterrupted run bitwise."""
    _, bst, _ = states
    cfg = cfg_of(pt, "dense")
    full = ck.trace_rays_chunked(bst, cfg, chunk_steps=CHUNK, verbose=False)
    path = str(tmp_path / "ck.npz")
    chained = None
    for attempt in range(40):
        try:
            chained = ck.trace_rays_chunked(
                bst, cfg, chunk_steps=CHUNK, checkpoint_path=path,
                verbose=False, max_chunks=1)
            break
        except ck.ChunkBudgetReached as e:
            assert 0 < e.step < e.nt
    assert chained is not None, "never completed"
    assert attempt >= 2, "budget never fired; test is vacuous"
    assert_bitwise(full, chained)


def test_budget_requires_checkpoint(states):
    """(c) A budget without a checkpoint to resume from is refused."""
    _, bst, _ = states
    with pytest.raises(ValueError, match="checkpoint_path"):
        ck.trace_rays_chunked(bst, cfg_of(pt, "dense"), chunk_steps=CHUNK,
                              verbose=False, max_chunks=1)


def test_resume_across_compaction(states, tmp_path):
    """(d) Resume from a checkpoint written after the batch compacted: the
    stored lane subset is adopted and the result is bitwise the
    uninterrupted run's."""
    _, bst, _ = states
    cfg = cfg_of(pt, "exact_peel", **TIGHT)
    kw = dict(chunk_steps=12, verbose=False, compact_min_width=16)
    full = ck.trace_rays_chunked(bst, cfg, **kw)
    path = str(tmp_path / "run.npz")
    ck.trace_rays_chunked(bst, cfg_of(pt, "exact_peel", cut_off=0.01),
                          checkpoint_path=path, **kw)
    with np.load(path) as ds:
        assert ds["lanes"].shape[0] < 126, "no compaction before the resume"
        assert int(ds["step"]) == 49
    resumed = ck.trace_rays_chunked(bst, cfg, checkpoint_path=path, **kw)
    assert_bitwise(full, resumed)


def test_checkpoint_from_other_sources_rejected(states, tmp_path):
    """(d) A checkpoint of a smaller source configuration passes the lane
    subset check by accident; the ray count refuses it."""
    _, bst, _ = states
    path = str(tmp_path / "ck.npz")
    ck.trace_rays_chunked(bst, cfg_of(pt, "exact_peel", nny=2),
                          chunk_steps=12, verbose=False,
                          checkpoint_path=path)
    with pytest.raises(ValueError, match="source configuration differs"):
        ck.trace_rays_chunked(bst, cfg_of(pt, "exact_peel"), chunk_steps=12,
                              verbose=False, checkpoint_path=path)


def test_stream_dir_is_memmap_backed(states, tmp_path):
    """(e) Streamed outputs equal the in-memory run and are views of the
    ``<var>.npy`` memmaps: a write to the file shows in the tensor."""
    _, bst, _ = states
    cfg = cfg_of(pt, "dense")
    mem = ck.trace_rays_chunked(bst, cfg, chunk_steps=CHUNK, verbose=False)
    out = ck.trace_rays_chunked(bst, cfg, chunk_steps=CHUNK, verbose=False,
                                stream_dir=str(tmp_path))
    assert_bitwise(mem, out)
    m = np.load(os.path.join(tmp_path, "lat.npy"), mmap_mode="r+")
    assert m.shape == (49, 180)
    m[5, 7] = 123.0
    m.flush()
    assert float(out.lat.reshape(49, -1)[5, 7]) == 123.0


def test_jax_checkpoint_resumes_in_the_port(states, jax_runs, tmp_path):
    """(f) The JAX driver stops on a chunk budget; the port resumes from
    its checkpoint and finishes within (a)'s bars of the uninterrupted JAX
    run."""
    bsj, bst, _ = states
    path = str(tmp_path / "ck.npz")
    with pytest.raises(jck.ChunkBudgetReached):
        jck.trace_rays_chunked(bsj, cfg_of(rt, "dense"), chunk_steps=CHUNK,
                               verbose=False, checkpoint_path=path,
                               max_chunks=2)
    with np.load(path) as ds:
        assert int(ds["step"]) == 1 + 2 * CHUNK
    out = ck.trace_rays_chunked(bst, cfg_of(pt, "dense"), chunk_steps=CHUNK,
                                verbose=False, checkpoint_path=path)
    ref, spread = jax_runs["dense"]
    assert_within_jax_bars(ref, out, spread)


@pytest.mark.parametrize("branch", ["rk4", "exact_peel"])
def test_all_dead_stops_early(states, branch):
    """(g) At a cut-off of 1e-9 every born ray dies at step 1: the driver
    stops after its first chunk and fills the tail as the JAX driver does
    (rootless lanes frozen at their seeds in rk45, NaN in rk4)."""
    bsj, bst, _ = states
    ref = jck.trace_rays_chunked(bsj, cfg_of(rt, branch, cut_off=1e-9),
                                 chunk_steps=CHUNK, verbose=False)
    stats = {}
    out = ck.trace_rays_chunked(bst, cfg_of(pt, branch, cut_off=1e-9),
                                chunk_steps=CHUNK, verbose=False,
                                stats=stats)
    assert len(stats["chunk_ms"]) == 1
    a, b = rows(ref), rows(out)
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    np.testing.assert_array_equal(np.nan_to_num(a[1:]), np.nan_to_num(b[1:]))
    assert np.isnan(b[1:, :, np.isfinite(b[0, 4])]).all()


def test_truncation_raises_and_keeps_the_last_checkpoint(states, tmp_path,
                                                         monkeypatch):
    """(h) A chunk whose unit leaves a live lane at the max_iters backstop
    raises ``MaxItersTruncation`` naming its output steps; the checkpoint
    holds the chunks before it."""
    _, bst, _ = states
    calls = []
    unit = ttracer._exact_run

    def short_second_chunk(*args, **kw):
        calls.append(1)
        if len(calls) == 2:
            args = args[:12] + (3,) + args[13:]
        return unit(*args, **kw)

    monkeypatch.setattr(ttracer, "_exact_run", short_second_chunk)
    path = str(tmp_path / "ck.npz")
    stats = {}
    with pytest.raises(ttracer.MaxItersTruncation, match=r"steps 9\.\.16"):
        ck.trace_rays_chunked(bst, cfg_of(pt, "exact_peel"),
                              chunk_steps=CHUNK, verbose=False,
                              checkpoint_path=path, stats=stats)
    assert len(calls) == 2 and len(stats["lane_att"]) == 2
    assert int(stats["lane_att"][1].max()) == 3
    with np.load(path) as ds:
        assert int(ds["step"]) == 1 + CHUNK


@pytest.mark.parametrize("state", ["compute", "float64"],
                         ids=["float64", "mixed"])
def test_trace_rays_reroutes_past_auto_chunk_bytes(states, state):
    """(i) Past ``auto_chunk_bytes`` ``trace_rays`` returns the chunked
    driver's run (host tensors), bitwise; in float64 and in mixed
    precision."""
    _, bst, bs32 = states
    bs = bst if state == "compute" else bs32
    cfg = cfg_of(pt, "dense", state_dtype=state,
                 cal_dtype=str(bs.fields.dtype)[6:])
    stats = {}
    got = pt.trace_rays(bs, cfg, auto_chunk_bytes=1000, stats=stats)
    want = ck.trace_rays_chunked(bs, cfg, verbose=False)
    assert got.lon.device.type == "cpu" and got.lon.dtype == torch.float64
    assert len(stats["lane_att"]) == 1
    assert_bitwise(want, got)


@pytest.mark.parametrize("branch", ["mesh"])
def test_unported_branches_raise(states, branch):
    """Every branch is ported; a ``mesh`` that is not a
    ``parallel.sharding.Mesh`` raises TypeError before the run (the
    mesh's chunked runs: tests/test_torch_parallel.py)."""
    _, bst, _ = states
    with pytest.raises(TypeError, match="Mesh"):
        ck.trace_rays_chunked(bst, cfg_of(pt, "dense"), verbose=False,
                              mesh=object())
