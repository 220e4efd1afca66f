"""The file-driven pipeline of the port against the JAX package's.

Each case of tests/test_io_main.py, run through ``rwrt_tpu.main.run`` /
``rwrt_tpu.__main__.main`` and through the port's ``rwrt_tpu_torch.main.run``
/ ``rwrt_tpu_torch.__main__.main([..., "--device", "cpu"])`` on the same
input files (the ``jet_field`` background, float64), the files compared.

Bars. RK4 runs: every file variable within 1e-10 of JAX's relative to its
largest magnitude, NaN masks identical. rk45 runs: NaN masks identical and
the lon/lat RMSE under 0.1 degree (tests/test_torch_trace.py's bars).
Basic-state fields: within 1e-11 of their largest magnitude
(tests/test_torch_basic_state.py's bar). ``regrid_to_uniform`` and
``load_wind``: bitwise. Each package's loaders read the other's files.
"""

import json
import os

import numpy as np
import pytest
import torch

import rwrt_tpu as rt
import rwrt_tpu_torch as pt
from rwrt_tpu.__main__ import main as jax_cli
from rwrt_tpu.io import ncio as jio
from rwrt_tpu.main import RunPaths as JPaths
from rwrt_tpu.main import run as jax_run
from rwrt_tpu_torch import main as pmain
from rwrt_tpu_torch.__main__ import main as port_cli
from rwrt_tpu_torch.io import ncio as pio

HOUR, DAY = 3600.0, 86400.0
RK4 = dict(zwn=(3.0,), sw_lon=10.0, sw_lat=20.0, dlon=1.0, dlat=1.0, nnx=2,
           nny=1, tstep=2 * HOUR, ttotal=1 * DAY, integrator="rk4",
           cal_dtype="float64")
RK45 = dict(RK4, integrator="rk45")


def save_wind(path, u, v, lat, lon, **extra):
    """Store (.., nlon, nlat) winds in the NetCDF convention: (.., lat,
    lon), degrees."""
    np.savez(path, u=np.swapaxes(u, -1, -2), v=np.swapaxes(v, -1, -2),
             lat=np.degrees(lat), lon=np.degrees(lon), **extra)
    return str(path)


def both_runs(tmp_path, cfg, inputuv, tag="", **kw):
    """The JAX and the port's ``run`` on the same input, each writing its
    trajectory (and, with ``bs=True``, basic-state) file; returns the two
    trajectory results and the two output path dicts."""
    bs = kw.pop("bs", False)
    outs = []
    for name, run, RunConfig, Paths, extra in (
            ("jax", jax_run, rt.RunConfig, JPaths, {}),
            ("port", pmain.run, pt.RunConfig, pmain.RunPaths,
             dict(device="cpu"))):
        files = dict(ncfile=str(tmp_path / f"{name}{tag}_rays.npz"),
                     bsfile=(str(tmp_path / f"{name}{tag}_bs.npz")
                             if bs else None))
        traj = run(RunConfig(**cfg), Paths(inputuv=inputuv, **files),
                   verbose=False, **extra, **kw)
        outs.append((traj, files))
    return outs


def assert_close(ref, got, rtol=1e-10):
    """Two dicts of arrays (file contents): same keys, shapes and NaN
    masks, values within rtol of each variable's largest magnitude."""
    assert sorted(ref) == sorted(got)
    for k in ref:
        a, b = np.asarray(ref[k]), np.asarray(got[k])
        assert a.shape == b.shape, k
        if a.dtype.kind != "f":
            np.testing.assert_array_equal(a, b, err_msg=k)
            continue
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=k)
        scale = np.nanmax(np.abs(a)) if np.isfinite(a).any() else 0.0
        np.testing.assert_allclose(b, a, rtol=0, atol=rtol * max(scale, 1e-300),
                                   equal_nan=True, err_msg=k)


def assert_rk45_close(ref, got):
    """rk45 files: identical NaN masks everywhere, lon/lat RMSE < 0.1 deg."""
    assert sorted(ref) == sorted(got)
    for k in ref:
        a, b = np.asarray(ref[k]), np.asarray(got[k])
        assert a.shape == b.shape, k
        if a.dtype.kind == "f":
            np.testing.assert_array_equal(np.isnan(a), np.isnan(b),
                                          err_msg=k)
    la, lb = ref["rlat"], got["rlat"]
    dlon = (ref["rlon"] - got["rlon"] + 180.0) % 360.0 - 180.0
    both = np.isfinite(la) & np.isfinite(lb)
    assert both.any()
    err = np.concatenate([(dlon * np.cos(np.radians(la)))[both],
                          (la - lb)[both]])
    assert np.sqrt(np.mean(err ** 2) * 2) < 0.1


def load(path):
    with np.load(path) as ds:
        return {k: ds[k] for k in ds.files}


def test_load_wind_npz_latflip_and_transpose(tmp_path, jet_field):
    u, v, lat, lon = jet_field
    path = str(tmp_path / "wind.npz")
    np.savez(path, u=u.T[::-1], v=v.T[::-1], lat=np.degrees(lat)[::-1],
             lon=np.degrees(lon))
    got, ref = pio.load_wind(path), jio.load_wind(path)
    for a, b in zip(ref, got):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(got[0], u.astype(np.float32), rtol=1e-6)
    assert got[2][0] < got[2][-1]


def test_load_wind_3d_latflip_and_time(tmp_path, jet_field):
    u, v, lat, lon = jet_field
    path = str(tmp_path / "wind3d.npz")
    np.savez(path,
             u=np.swapaxes(np.stack([u, 2 * u, 3 * u]), 1, 2)[:, ::-1],
             v=np.swapaxes(np.stack([v, v, v]), 1, 2)[:, ::-1],
             lat=np.degrees(lat)[::-1], lon=np.degrees(lon),
             time=np.array([0.0, 3600.0, 7200.0]))
    got = pio.load_wind(path, with_time=True)
    ref = jio.load_wind(path, with_time=True)
    assert got[0].shape == (3,) + u.shape
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(a, b)
    assert len(pio.load_wind(path)) == 4


def test_load_wind_normalizes_negative_longitudes(tmp_path, jet_field):
    """A -180..180 grid is rolled to the 0-based convention (as the JAX
    loader does, bitwise); the runs equal the same field stored 0..360."""
    u, v, lat, lon = jet_field
    k = lon.shape[0] // 2
    lon_neg = np.degrees(lon).copy()
    lon_neg[lon_neg >= 180.0] -= 360.0
    lon_neg = np.roll(lon_neg, k)
    p_neg = str(tmp_path / "wneg.npz")
    np.savez(p_neg, u=np.roll(u, k, axis=0).T, v=np.roll(v, k, axis=0).T,
             lat=np.degrees(lat), lon=lon_neg)
    p_pos = save_wind(tmp_path / "wpos.npz", u, v, lat, lon)
    for a, b in zip(jio.load_wind(p_neg, "float64"),
                    pio.load_wind(p_neg, "float64")):
        np.testing.assert_array_equal(a, b)
    cfg = pt.RunConfig(**dict(RK45, ttotal=2 * DAY))
    ta, tb = (pmain.run(cfg, pmain.RunPaths(inputuv=p), verbose=False,
                        device="cpu") for p in (p_neg, p_pos))
    for name in ta._fields:
        assert torch.equal(getattr(ta, name).nan_to_num(),
                           getattr(tb, name).nan_to_num()), name


@pytest.mark.parametrize("varying", [False, True], ids=["static", "varying"])
def test_basic_state_output_fields(tmp_path, jet_field, varying):
    """The 23 fields + coordinates (and bg_t0/bg_dt of a time-varying
    state) against the JAX writer's, within 1e-11 of each field's max."""
    u, v, lat, lon = jet_field
    if varying:
        us, vs = np.stack([u, 1.1 * u]), np.stack([v, v])
        bsj = rt.prepare_time_varying(us, vs, lat, lon, bg_dt=DAY,
                                      cal_dtype="float64")
        bsp = pt.prepare_time_varying(us, vs, lat, lon, bg_dt=DAY,
                                      cal_dtype="float64", device="cpu")
    else:
        bsj = rt.prepare(u, v, lat, lon, cal_dtype="float64")
        bsp = pt.prepare(u, v, lat, lon, cal_dtype="float64", device="cpu")
    jio.write_basic_state(bsj, str(tmp_path / "j.npz"))
    pio.write_basic_state(bsp, str(tmp_path / "p.npz"))
    ref, got = load(tmp_path / "j.npz"), load(tmp_path / "p.npz")
    assert len(got) == 27 + 2 * varying  # 25 fields, lon, lat
    assert_close(ref, got, rtol=1e-11)
    shape = (2,) * varying + u.shape
    assert got["uxx"].shape == got["u"].shape == shape


def test_run_pipeline_end_to_end(tmp_path, jet_field):
    u, v, lat, lon = jet_field
    inp = save_wind(tmp_path / "wind.npz", u, v, lat, lon)
    (tj, fj), (tp, fp) = both_runs(tmp_path, RK4, inp, bs=True)
    ref, got = jio.load_trajectories(fj["ncfile"]), pio.load_trajectories(
        fp["ncfile"])
    assert got["rlon"].shape == (RK4["ttotal"] // RK4["tstep"] + 1, 3, 2, 1)
    assert_close(ref, got)
    # Each package's loader reads the other's file.
    assert_close(jio.load_trajectories(fp["ncfile"]), got, rtol=0)
    assert_close(load(fj["bsfile"]), load(fp["bsfile"]), rtol=1e-11)
    np.testing.assert_allclose(got["rlon"][0, 0, 0, 0], 10.0, atol=1e-10)
    # in-memory trajectories stay in radians
    assert abs(float(tp.lon[0, 0, 0, 0]) - np.radians(10.0)) < 1e-12


def test_run_time_varying_background_end_to_end(tmp_path, jet_field):
    """A 3-D (time, lat, lon) wind drives the time-varying pipeline, with
    the cadence from bg_dt or from the file's time variable; a 3-D wind
    with neither fails."""
    u, v, lat, lon = jet_field
    us = np.stack([u * (1.0 + 0.1 * i) for i in range(3)])
    vs = np.stack([v, v, v])
    inp = save_wind(tmp_path / "wind3d.npz", us, vs, lat, lon)
    cfg = dict(RK45, bg_dt=DAY)
    (_, fj), (tp, fp) = both_runs(tmp_path, cfg, inp, bs=True)
    assert_rk45_close(load(fj["ncfile"]), load(fp["ncfile"]))
    bsf = load(fp["bsfile"])
    assert bsf["u"].shape == bsf["uxx"].shape == (3,) + u.shape
    assert float(bsf["bg_dt"]) == DAY

    # The library path on the same frames (its coordinates not through
    # degrees) gives the same rows within 1e-12, as in the JAX test.
    bs = pt.prepare_time_varying(us.astype(np.float32), vs.astype(np.float32),
                                 lat, lon, bg_dt=DAY, cal_dtype="float64",
                                 device="cpu")
    ref = pt.trace_rays(bs, pt.RunConfig(**cfg)).lat.numpy()
    np.testing.assert_allclose(tp.lat.numpy(), ref, rtol=0, atol=1e-12,
                               equal_nan=True)

    save_wind(tmp_path / "wind3d.npz", us, vs, lat, lon,
              time=np.arange(3) * DAY)
    cfg2 = pt.RunConfig(**dict(cfg, bg_dt=0.0))
    t2 = pmain.run(cfg2, pmain.RunPaths(inputuv=inp), verbose=False,
                   device="cpu")
    assert torch.equal(tp.lat.nan_to_num(), t2.lat.nan_to_num())

    save_wind(tmp_path / "wind3d.npz", us, vs, lat, lon)
    with pytest.raises(ValueError, match="bg_dt"):
        pmain.run(cfg2, pmain.RunPaths(inputuv=inp), verbose=False,
                  device="cpu")


def test_run_regrid_gaussian_input(tmp_path, jet_field):
    """config.regrid=True ingests a Gaussian-latitude file that prepare
    refuses; regrid_to_uniform is bitwise the JAX package's."""
    u, v, lat, lon = jet_field
    glat = np.arcsin(np.polynomial.legendre.leggauss(lat.shape[0])[0])
    ug = np.stack([np.interp(glat, lat, row) for row in u])
    vg = np.stack([np.interp(glat, lat, row) for row in v])
    inp = save_wind(tmp_path / "gauss.npz", ug, vg, glat, lon)
    with pytest.raises(ValueError, match="regrid_to_uniform"):
        pmain.run(pt.RunConfig(**RK4), pmain.RunPaths(inputuv=inp),
                  verbose=False, device="cpu")
    for a, b in zip(rt.regrid_to_uniform(ug, vg, glat, lon),
                    pt.regrid_to_uniform(ug, vg, glat, lon)):
        np.testing.assert_array_equal(a, b)
    (_, fj), (_, fp) = both_runs(tmp_path, dict(RK4, regrid=True), inp)
    assert_close(load(fj["ncfile"]), load(fp["ncfile"]))


def test_member_path_edge_cases():
    from rwrt_tpu.main import _member_path as jax_member_path

    for template, i, want in (
            ("/tmp/run.dir/rays", 2, "/tmp/run.dir/rays_m002"),
            ("/tmp/run.dir/rays.npz", 0, "/tmp/run.dir/rays_m000.npz"),
            ("rays_{member}.npz", 3, "rays_3.npz"),
            (None, 1, None)):
        assert pmain._member_path(template, i) == want
        assert jax_member_path(template, i) == want


def test_run_with_shsf_ingest_smoothing(tmp_path, jet_field):
    """shsf_truncation smooths (u, v) at ingest as the JAX run does (the
    input read in float64, so the filter runs in float64 in both), and it
    changes the run."""
    u, v, lat, lon = jet_field
    u = u + 0.5 * np.random.default_rng(7).standard_normal(u.shape)
    inp = save_wind(tmp_path / "wind.npz", u, v, lat, lon)
    cfg = dict(RK4, shsf_truncation=8, read_dtype="float64")
    (_, fj), (tp, fp) = both_runs(tmp_path, cfg, inp)
    assert_close(load(fj["ncfile"]), load(fp["ncfile"]))
    raw = pmain.run(pt.RunConfig(**dict(cfg, shsf_truncation=None)),
                    pmain.RunPaths(inputuv=inp), verbose=False, device="cpu")
    a, b = tp.lat.numpy(), raw.lat.numpy()
    both = np.isfinite(a) & np.isfinite(b)
    assert not np.allclose(a[both], b[both])


@pytest.mark.parametrize("chunked", [False, True], ids=["fused", "chunked"])
def test_run_ensemble_from_file_list(tmp_path, jet_field, chunked):
    """A list-valued inputuv runs the ensemble sweep with per-member output
    files: fused (one trace_rays_ensemble) or member after member through
    the chunked driver, each member's file against the JAX package's."""
    u, v, lat, lon = jet_field
    inputs = [save_wind(tmp_path / f"wind_{i}.npz", u * (1.0 + 0.2 * i), v,
                        lat, lon) for i in range(2)]
    outs = both_runs(tmp_path, RK45, inputs, chunked=chunked)
    trajs = outs[1][0]
    assert len(trajs) == 2
    for i in range(2):
        ref, got = (load(pmain._member_path(f["ncfile"], i))
                    for _, f in outs)
        assert_rk45_close(ref, got)
    if chunked:
        fused = pmain.run(pt.RunConfig(**RK45),
                          pmain.RunPaths(inputuv=inputs), verbose=False,
                          device="cpu")
        for a, b in zip(trajs, fused):
            np.testing.assert_allclose(a.lat.numpy(), b.lat.numpy(), rtol=0,
                                       atol=1e-12, equal_nan=True)
    else:
        paths2 = pmain.RunPaths(inputuv=inputs,
                                ncfile=str(tmp_path / "rays_{member}.npz"))
        pmain.run(pt.RunConfig(**RK45), paths2, verbose=False, device="cpu")
        assert (tmp_path / "rays_0.npz").exists()
        assert (tmp_path / "rays_1.npz").exists()


@pytest.mark.parametrize("driver", ["trace_rays", "chunked"])
def test_initial_state_injection(jet_field, driver):
    """initial_state overrides the computed seeds (ug0, vg0 from the state),
    in trace_rays and in the chunked driver, as in the JAX package."""
    u, v, lat, lon = jet_field
    bsj = rt.prepare(u, v, lat, lon, cal_dtype="float64")
    bsp = pt.prepare(u, v, lat, lon, cal_dtype="float64", device="cpu")
    cfg = dict(RK4, nnx=1, zwn=(2.0, 3.0))
    base = rt.trace_rays(bsj, rt.RunConfig(**cfg))
    y0 = np.stack([np.asarray(getattr(base, k)[0]).reshape(-1)
                   for k in ("lon", "lat", "kx", "ky", "amp")])
    y0[1] += 0.05
    if driver == "chunked":
        from rwrt_tpu.utils.checkpoint import trace_rays_chunked as jchunked

        ref = jchunked(bsj, rt.RunConfig(**cfg), initial_state=y0,
                       verbose=False, chunk_steps=5)
        got = pt.trace_rays_chunked(bsp, pt.RunConfig(**cfg),
                                    initial_state=torch.as_tensor(y0),
                                    verbose=False, chunk_steps=5)
    else:
        ref = rt.trace_rays(bsj, rt.RunConfig(**cfg), initial_state=y0)
        got = pt.trace_rays(bsp, pt.RunConfig(**cfg), initial_state=y0)
    np.testing.assert_allclose(got.lat[0].numpy().reshape(-1), y0[1],
                               rtol=0, atol=0)
    assert_close({k: np.asarray(getattr(ref, k)) for k in ref._fields},
                 {k: getattr(got, k).numpy() for k in got._fields})
    with pytest.raises(ValueError, match="initial_state shape"):
        pt.trace_rays(bsp, pt.RunConfig(**cfg), initial_state=y0[:, 1:])


def test_load_basic_state_roundtrip(tmp_path, jet_field):
    """Stage-level restart: the port reloads its own file and the JAX
    package's, and JAX reloads the port's; the port's rays from a reloaded
    state equal those from the prepared one."""
    u, v, lat, lon = jet_field
    bsp = pt.prepare(u, v, lat, lon, cal_dtype="float64", device="cpu")
    pio.write_basic_state(bsp, str(tmp_path / "p.npz"))
    jio.write_basic_state(rt.prepare(u, v, lat, lon, cal_dtype="float64"),
                          str(tmp_path / "j.npz"))
    back = pio.load_basic_state(str(tmp_path / "p.npz"), cal_dtype="float64",
                                device="cpu")
    from_jax = pio.load_basic_state(str(tmp_path / "j.npz"),
                                    cal_dtype="float64", device="cpu")
    jax_back = jio.load_basic_state(str(tmp_path / "p.npz"),
                                    cal_dtype="float64")
    assert back.fields.device.type == "cpu"
    for name in ("fields", "lon", "lat", "betam", "ks", "q"):
        a = getattr(back, name).numpy()
        # The coordinates pass through degrees; the fields are stored.
        atol = 1e-15 if name in ("lon", "lat") else 0
        np.testing.assert_allclose(a, getattr(bsp, name).numpy(), rtol=0,
                                   atol=atol)
        np.testing.assert_array_equal(a, np.asarray(getattr(jax_back, name)))
        b = getattr(from_jax, name).numpy()
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=1e-11 * np.nanmax(np.abs(b)))
    cfg = pt.RunConfig(zwn=(2.0, 4.0), sw_lon=0.0, sw_lat=15.0, dlon=120.0,
                       dlat=10.0, nnx=2, nny=2, tstep=2 * HOUR,
                       ttotal=2 * DAY, integrator="rk4", cal_dtype="float64")
    a, b = pt.trace_rays(bsp, cfg), pt.trace_rays(back, cfg)
    np.testing.assert_allclose(a.lat.numpy(), b.lat.numpy(), rtol=0,
                               atol=1e-12, equal_nan=True)


def write_config(tmp_path, cfg, name="run.json"):
    path = str(tmp_path / name)
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def test_cli_end_to_end(tmp_path, jet_field):
    """python -m rwrt_tpu_torch --config run.json --device cpu against
    python -m rwrt_tpu on the same JSON; --wnmaps too."""
    u, v, lat, lon = jet_field
    inp = save_wind(tmp_path / "wind.npz", u, v, lat, lon)
    cfg = dict({k: list(x) if isinstance(x, tuple) else x
                for k, x in RK4.items()}, inputuv=inp, nnx=1)
    files = {}
    for name, cli, extra in (("jax", jax_cli, []),
                             ("port", port_cli, ["--device", "cpu"])):
        files[name] = (str(tmp_path / f"{name}_rays.npz"),
                       str(tmp_path / f"{name}_wn.npz"))
        path = write_config(tmp_path, dict(cfg, ncfile=files[name][0]),
                            f"{name}.json")
        assert cli(["--config", path, "--wnmaps", files[name][1]]
                   + extra) == 0
    got = pio.load_trajectories(files["port"][0])
    assert got["rlon"].shape[0] == 13
    assert_close(pio.load_trajectories(files["jax"][0]), got)
    wn_ref, wn = load(files["jax"][1]), load(files["port"][1])
    assert wn["mwn"].shape == (u.shape[0], u.shape[1], 1, 3)
    assert_close(wn_ref, wn)


def test_cli_run_report(tmp_path, jet_field):
    """--report: JAX's keys (versions and the device in place of JAX's),
    the grid, the wall split and termination counts equal to JAX's; the
    ensemble report's members."""
    u, v, lat, lon = jet_field
    inp = save_wind(tmp_path / "wind.npz", u, v, lat, lon)
    cfg = {"inputuv": inp, "zwn": [2.0, 3.0], "sw_lon": 10.0,
           "sw_lat": 15.0, "dlon": 5.0, "dlat": 5.0, "nnx": 2, "nny": 2,
           "tstep": 7200.0, "ttotal": 86400.0, "integrator": "rk4",
           "cal_dtype": "float64"}
    path = write_config(tmp_path, cfg)
    reps = {}
    for name, cli, extra in (("jax", jax_cli, []),
                             ("port", port_cli, ["--device", "cpu"])):
        rep_path = str(tmp_path / f"{name}_report.json")
        assert cli(["--config", path, "--report", rep_path] + extra) == 0
        with open(rep_path) as f:
            reps[name] = json.load(f)
    rep, ref = reps["port"], reps["jax"]
    gone = {"jax_version"}
    added = {"torch_version", "cuda_version", "device_name"}
    assert set(rep) == (set(ref) - gone) | added
    assert rep["framework"] == "rwrt_tpu_torch"
    assert rep["backend"] == "cpu" and rep["n_devices"] == 1
    assert rep["torch_version"] == torch.__version__
    assert rep["config"] == ref["config"]
    assert rep["grid"] == {"nlon": u.shape[0], "nlat": u.shape[1],
                           "time_varying": False}
    assert rep["trajectories"] == {**ref["trajectories"],
                                   "final_alive_frac": rep["trajectories"][
                                       "final_alive_frac"]}
    assert abs(rep["trajectories"]["final_alive_frac"]
               - ref["trajectories"]["final_alive_frac"]) < 1e-12
    tsum = rep["trajectories"]
    assert sum(tsum["termination"].values()) == tsum["n_rays"] == 24
    assert set(rep["wall_s"]) == {"prepare", "trace", "io", "total"}
    assert rep["wall_s"]["total"] >= rep["wall_s"]["trace"] > 0

    path = write_config(tmp_path, dict(cfg, inputuv=[inp, inp]))
    rep_path = str(tmp_path / "report2.json")
    assert port_cli(["--config", path, "--report", rep_path, "--device",
                     "cpu"]) == 0
    with open(rep_path) as f:
        rep2 = json.load(f)
    assert rep2["n_members"] == 2 and len(rep2["members"]) == 2
    assert rep2["members"][0]["termination"] == tsum["termination"]


def test_cli_rejects_unknown_and_missing_config_keys(tmp_path):
    cfg = {"inputuv": "x.npz", "zwn": [3.0], "no_such_knob": 1}
    p = write_config(tmp_path, cfg, "bad.json")
    with pytest.raises(SystemExit) as e:
        port_cli(["--config", p, "--device", "cpu"])
    assert e.value.code == 2
    del cfg["no_such_knob"], cfg["inputuv"]
    p = write_config(tmp_path, cfg, "bad.json")
    with pytest.raises(SystemExit) as e:
        port_cli(["--config", p, "--device", "cpu"])
    assert e.value.code == 2


def test_wnmaps_time_varying_through_cli_surface(tmp_path, jet_field):
    """--wnmaps on a 3-D input: one map set per frame, time coordinates
    from bg_dt, against the JAX package's file."""
    u, v, lat, lon = jet_field
    inp = save_wind(tmp_path / "wind3d.npz", np.stack([u, 1.2 * u]),
                    np.stack([v, v]), lat, lon)
    cfg = dict(RK45, bg_dt=DAY)
    wn = {name: str(tmp_path / f"{name}_wn3d.npz") for name in ("j", "p")}
    jax_run(rt.RunConfig(**cfg), JPaths(inputuv=inp), verbose=False,
            wnmaps_path=wn["j"])
    pmain.run(pt.RunConfig(**cfg), pmain.RunPaths(inputuv=inp),
              verbose=False, wnmaps_path=wn["p"], device="cpu")
    got = load(wn["p"])
    assert got["mwn"].shape == (2, u.shape[0], u.shape[1], 1, 3)
    assert got["rootnum"].shape == (2, u.shape[0], u.shape[1], 1)
    assert got["KS"].shape == (2, u.shape[0], u.shape[1])
    np.testing.assert_array_equal(got["time"], [0.0, DAY])
    assert_close(load(wn["j"]), got)


# The case keeps the id it had while the flag was refused.
@pytest.mark.parametrize("flag,devices", [("--mesh", 3)],
                         ids=["--mesh-Slice 6"])
def test_cli_unported_branch_raises_before_load(tmp_path, jet_field, flag,
                                                devices):
    """Every flag is ported: --mesh splits the rays over a mesh of
    ``mesh_devices`` CPU entries (one without it), its files bitwise the
    run's without the flag, the report's "mesh" {"rays": n} (JAX's
    report's form of its mesh's shape)."""
    u, v, lat, lon = jet_field
    inp = save_wind(tmp_path / "wind.npz", u, v, lat, lon)
    cfg = dict({k: list(x) if isinstance(x, tuple) else x
                for k, x in RK45.items()}, inputuv=inp, nnx=3)
    runs = {}
    for name, extra, conf in (
            ("plain", [], {}), ("one", [flag], {}),
            ("mesh", [flag], {"mesh_devices": devices})):
        files = {k: str(tmp_path / f"{name}_{k}.npz") for k in ("rays", "wn")}
        path = write_config(tmp_path, dict(cfg, ncfile=files["rays"], **conf),
                            f"{name}.json")
        rep = str(tmp_path / f"{name}_report.json")
        assert port_cli(["--config", path, "--device", "cpu", "--report",
                         rep, "--wnmaps", files["wn"]] + extra) == 0
        with open(rep) as f:
            runs[name] = json.load(f)["mesh"], files
    assert runs["plain"][0] is None
    assert runs["one"][0] == {"rays": 1}
    assert runs["mesh"][0] == {"rays": devices}
    for name in ("one", "mesh"):
        for k, path in runs[name][1].items():
            ref, got = load(runs["plain"][1][k]), load(path)
            assert sorted(ref) == sorted(got)
            for key in ref:
                np.testing.assert_array_equal(ref[key], got[key],
                                              err_msg=f"{name} {k} {key}")


def test_cuda_run_without_a_card_is_an_error(tmp_path, jet_field):
    """The default device is the card; without one the run raises and does
    not fall back to the host."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    u, v, lat, lon = jet_field
    inp = save_wind(tmp_path / "wind.npz", u, v, lat, lon)
    p = write_config(tmp_path, {"inputuv": inp, "zwn": [3.0]})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_cli(["--config", p])


def test_netcdf_gate(tmp_path, jet_field):
    """Without netCDF4 a NetCDF input raises the JAX package's
    RuntimeError and writers fall back to <path>.npz, which both packages'
    loaders read."""
    if pio.HAVE_NETCDF:
        pytest.skip("netCDF4 is installed")
    with pytest.raises(RuntimeError, match="netCDF4"):
        pio.load_wind(str(tmp_path / "uv.nc"))
    u, v, lat, lon = jet_field
    bs = pt.prepare(u, v, lat, lon, cal_dtype="float64", device="cpu")
    pio.write_basic_state(bs, str(tmp_path / "bs.nc"))
    assert (tmp_path / "bs.nc.npz").exists()
    with pytest.raises(RuntimeError, match="netCDF4"):
        pio.load_basic_state(str(tmp_path / "bs.nc"), device="cpu")
    jio.load_basic_state(str(tmp_path / "bs.nc.npz"), cal_dtype="float64")


def test_profile_writes_a_chrome_trace(tmp_path, jet_field):
    from rwrt_tpu_torch.utils import profile

    u, v, lat, lon = jet_field
    with profile(str(tmp_path / "prof")) as prof:
        pt.prepare(u, v, lat, lon, cal_dtype="float64", device="cpu")
    assert len(prof.key_averages()) > 0
    with open(tmp_path / "prof" / "trace.json") as f:
        assert "traceEvents" in json.load(f)
