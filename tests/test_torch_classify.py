"""Exact death causes of the port against the JAX package's.

``termination.classify`` re-runs each dead ray's killing interval and
labels the death polar, jump, runaway or other. Each package classifies the
very same trajectory on the same basic state, in RK4 and in RK45: traced by
the JAX package on tests/test_termination_rate.py's critical-line field
(float64), with two deaths planted so that every label shows, and carried
to the port with ``convert``. On this field RK4 deaths are jumps (its step
freezes a lane whose stage trips the RHS mask, so a runaway NaN never
reaches its candidate) and RK45 deaths runaways and jumps (no candidate
crosses a pole); the planted ones: a survivor cut short, which the re-run
does not reproduce (other), and in RK4 a last state past the pole (polar).

Bars: the four cause counts, no_root and survived equal to JAX's; every
lane in exactly one bucket; the labels above present. Then the file-driven
run with ``--report-exact`` (``main.run(report_exact_causes=True)``,
single, chunked and ensemble runs) against the JAX CLI's report on the
same input files: the same counts.
"""

import json

import numpy as np
import pytest

import rwrt_tpu as rt
import rwrt_tpu_torch as pt
from rwrt_tpu.__main__ import main as jax_cli
from rwrt_tpu.diagnostics import termination as jterm
from rwrt_tpu_torch import convert
from rwrt_tpu_torch.__main__ import main as port_cli
from rwrt_tpu_torch.diagnostics import termination as pterm
from rwrt_tpu_torch.models import ray

HOUR, DAY = 3600.0, 86400.0
CAUSES = ("polar", "jump", "runaway", "other")
#: The critical-line workload (tests/test_termination_rate.py's), per
#: integrator: RK4 over 12 days with a tighter jump threshold, RK45 over
#: the test's 20 days.
CFG = dict(zwn=(1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 7.0), sw_lon=0.0,
           sw_lat=-50.0, dlon=60.0, dlat=12.0, nnx=6, nny=8,
           tstep=2 * HOUR, cal_dtype="float64")
RUNS = {"rk4": dict(integrator="rk4", ttotal=12 * DAY, cut_off=0.03),
        "rk45": dict(integrator="rk45", ttotal=20 * DAY, cut_off=0.1)}
#: The labels each run must show (planted ones included).
SHOWN = {"rk4": ("polar", "jump", "other"),
         "rk45": ("jump", "runaway", "other")}


@pytest.fixture(scope="module")
def critical_line_field():
    """Jets + tropical easterlies: rays launched in midlatitudes propagate
    equatorward into the u < 0 belt, where they die at the critical line
    (runaway |m|), by a jump, or at the pole."""
    nlon, nlat = 72, 37
    lat = np.linspace(-np.pi / 2, np.pi / 2, nlat)
    lon = np.arange(nlon) * 2 * np.pi / nlon
    u = (
        -28.0 * np.cos(lat)[None, :] ** 2 * np.cos(2 * lat)[None, :]
        + 30.0 * np.exp(-(((np.degrees(lat)[None, :] - 40.0) / 10.0) ** 2))
        + 25.0 * np.exp(-(((np.degrees(lat)[None, :] + 45.0) / 10.0) ** 2))
        + 6.0 * np.cos(3 * lon)[:, None] * np.cos(lat)[None, :] ** 2
    )
    v = 5.0 * np.sin(2 * lon)[:, None] * np.cos(lat)[None, :]
    return u, v, lat, lon


def plant_deaths(traj, polar):
    """Two survivors of ``traj`` (numpy fields) made to die at step 5: one
    cut short (its rows from 5 NaN), and with ``polar`` one whose row 4
    lies past the pole."""
    d = {k: np.array(x) for k, x in traj._asdict().items()}
    alive = np.argwhere(np.isfinite(d["amp"][-1]))
    for n, (r, s, z) in enumerate(alive[:2 if polar else 1]):
        for x in d.values():
            x[5:, r, s, z] = np.nan
        if n == 1:
            d["lat"][4, r, s, z] = np.pi / 2 + 0.02
    return d


@pytest.fixture(scope="module", params=list(RUNS))
def traced(request, critical_line_field):
    """(JAX basic state, config, trajectory; the port's state, config and
    the same trajectory) for one integrator."""
    u, v, lat, lon = critical_line_field
    cfg = dict(CFG, **RUNS[request.param])
    bs = rt.prepare(u, v, lat, lon, cal_dtype="float64")
    jcfg = rt.RunConfig(**cfg)
    d = plant_deaths(rt.trace_rays(bs, jcfg), request.param == "rk4")
    traj = rt.RayTrajectories(**d)
    pbs = convert.basic_state_from_numpy(
        {k: np.asarray(x) for k, x in bs._asdict().items()}, device="cpu")
    ptraj = convert.trajectories_from_numpy(d, device="cpu")
    return (request.param, bs, jcfg, traj, pbs, pt.RunConfig(**cfg),
            ptraj)


def test_classify_counts_equal_jax(traced):
    run, bs, jcfg, traj, pbs, pcfg, ptraj = traced
    want = jterm.classify(traj, bs, jcfg)
    got = pterm.classify(ptraj, pbs, pcfg)
    assert got.counts == want.counts
    np.testing.assert_array_equal(got.death_step, want.death_step)
    np.testing.assert_array_equal(got.alive_frac, want.alive_frac)
    assert sum(got.counts.values()) == got.death_step.size
    assert all(got.counts[c] > 0 for c in SHOWN[run]), got.counts


def test_cause_labels_plain_rhs_equal_dispatching(traced):
    """On the CPU ``ray.rhs`` runs ``_rhs_core``: the per-lane labels
    through the dispatching RHS and through the plain one are the same,
    and count as ``classify`` counts them."""
    *_, pbs, pcfg, ptraj = traced
    death = pterm.analyze(ptraj).death_step
    a = pterm.cause_labels(ptraj, pbs, pcfg, death)
    b = pterm.cause_labels(
        ptraj, pbs, pcfg, death,
        rhs=lambda bg, y, t: ray._rhs_core(bg, y, t, False)[:2])
    np.testing.assert_array_equal(a, b)
    counts = pterm.classify(ptraj, pbs, pcfg).counts
    assert [int((a == i).sum()) for i in range(4)] == [counts[c]
                                                       for c in CAUSES]


def test_classify_without_deaths_and_max_rays(traced):
    """No dead ray: all four causes count 0 and nothing re-runs; more dead
    rays than max_rays raises, as in the JAX package."""
    *_, pbs, pcfg, ptraj = traced
    alive = ptraj._replace(**{k: getattr(ptraj, k)[:1]
                              for k in ptraj._fields})
    rep = pterm.classify(alive, pbs, pcfg)
    assert all(rep.counts[c] == 0 for c in CAUSES)
    with pytest.raises(ValueError, match="max_rays"):
        pterm.classify(ptraj, pbs, pcfg, max_rays=1)


def save_wind(path, u, v, lat, lon):
    np.savez(path, u=np.swapaxes(u, -1, -2), v=np.swapaxes(v, -1, -2),
             lat=np.degrees(lat), lon=np.degrees(lon))
    return str(path)


@pytest.mark.parametrize("case", ["rk4", "rk4_chunked", "ensemble"])
def test_report_exact_equals_jax_cli(tmp_path, critical_line_field, case):
    """``--report-exact`` through both CLIs on the same wind file(s): the
    report's termination counts (per member for an ensemble) equal, and
    marked exact."""
    u, v, lat, lon = critical_line_field
    wind = save_wind(tmp_path / "wind.npz", u, v, lat, lon)
    cfg = dict(CFG, **RUNS["rk4"], inputuv=wind)
    cfg["zwn"] = [2.0, 4.0]
    flags = ["--report-exact"]
    if case == "rk4_chunked":
        flags.append("--chunked")
    if case == "ensemble":
        wind2 = save_wind(tmp_path / "wind2.npz", 1.1 * u, v, lat, lon)
        cfg["inputuv"] = [wind, wind2]
    reports = []
    for name, cli, extra in (("jax", jax_cli, []),
                             ("port", port_cli, ["--device", "cpu"])):
        path = tmp_path / f"{name}.json"
        path.write_text(json.dumps(cfg))
        out = tmp_path / f"{name}_report.json"
        assert cli(["--config", str(path), "--report", str(out)] + flags
                   + extra) == 0
        rep = json.loads(out.read_text())
        reports.append(rep.get("members") or [rep["trajectories"]])
    for j, p in zip(*reports):
        assert p["termination_causes"] == j["termination_causes"] == "exact"
        assert p["termination"] == j["termination"]
    died = sum(reports[1][0]["termination"][c] for c in CAUSES)
    assert died > 0, reports[1][0]["termination"]

