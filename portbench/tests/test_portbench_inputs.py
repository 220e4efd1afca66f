"""Seed 0 makes the inputs of the repository's earlier measurements
(chip_smoke.py, bench.py) to the bit; other seeds lay the same sources out
in another order, and change nothing else."""

import json
from pathlib import Path

import numpy as np
import pytest

import bench
import chip_smoke as cs
from portbench import inputs

HERE = Path(__file__).resolve().parent.parent


def cfg(name):
    return json.loads((HERE / "configs" / f"{name}.json").read_text())


def traffic(name):
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


def same(a, b):
    return a.shape == b.shape and np.array_equal(a, b)


def test_static_seed0_is_the_climatology():
    got = inputs.make_inputs(cfg("dense_rk45_f32"), traffic("static"), 0)
    (w,) = got.winds
    for want in (cs.climatology_background(), bench.climatology_background()):
        assert all(same(a, b) for a, b in zip((w.u, w.v, w.lat, w.lon),
                                              want))
    assert w.frame_dt is None


def test_dense_seed0_sources_are_chip_smokes():
    got = inputs.make_inputs(cfg("dense_rk45_f32"), traffic("static"), 0)
    rng = np.random.default_rng(0)
    want_lon = rng.uniform(0, 2 * np.pi, cs.N_SOURCES)
    want_lat = rng.uniform(np.radians(-65), np.radians(65), cs.N_SOURCES)
    assert same(got.source_lon, want_lon) and same(got.source_lat, want_lat)


def test_members_seed0_are_chip_smokes():
    got = inputs.make_inputs(cfg("dense_rk45_f32"), traffic("members4"), 0)
    assert len(got.winds) == len(cs.MEMBER_SCALES)
    for w, sc, ph in zip(got.winds, cs.MEMBER_SCALES, cs.MEMBER_PHASES):
        u, v, lat, lon = cs.climatology_frames(1, sc, ph)
        assert same(w.u, u[0]) and same(w.v, v[0])


def test_daily_seed0_are_chip_smokes():
    got = inputs.make_inputs(cfg("dense_rk45_f32"), traffic("daily31"), 0)
    (w,) = got.winds
    u, v, lat, lon = cs.climatology_frames(cs.TV_DAYS + 1)
    assert same(w.u, u) and same(w.v, v) and w.frame_dt == cs.DAY


def test_rk4_seed0_sources_are_the_ports_matrix():
    import rwrt_tpu_torch as rt

    config = cfg("rk4_f64_reference")
    got = inputs.make_inputs(config, traffic("static"), 0)
    r = rt.RunConfig(**config["run"])
    want = rt.source_matrix(r.sw_lon, r.sw_lat, r.dlon, r.dlat, r.nnx, r.nny)
    assert same(got.source_lon, want[0]) and same(got.source_lat, want[1])
    assert inputs.ray_count(config, got) == 6615


@pytest.mark.parametrize("name", ["dense_rk45_f32", "rk4_f64_reference"])
@pytest.mark.parametrize("seed", [1, 2 ** 31 + 12345, 9_876_543_210])
def test_other_seeds_reorder_the_same_sources(name, seed):
    base = inputs.make_inputs(cfg(name), traffic("members4"), 0)
    got = inputs.make_inputs(cfg(name), traffic("members4"), seed)
    again = inputs.make_inputs(cfg(name), traffic("members4"), seed)
    order = np.lexsort((got.source_lat, got.source_lon))
    base_order = np.lexsort((base.source_lat, base.source_lon))
    assert not same(got.source_lon, base.source_lon)
    assert same(got.source_lon[order], base.source_lon[base_order])
    assert same(got.source_lat[order], base.source_lat[base_order])
    assert same(got.source_lon, again.source_lon)
    for w, b in zip(got.winds, base.winds, strict=True):
        assert same(w.u, b.u) and same(w.v, b.v)
    assert inputs.ray_count(cfg(name), got) == inputs.ray_count(cfg(name),
                                                                base)
