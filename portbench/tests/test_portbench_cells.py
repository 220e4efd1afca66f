"""The harness end to end on the CPU at a tiny size: a cell added as data
files alone is found and runs correct; the control and each fault of the
timed path come out not correct; a run without a card prints no result;
``BENCHMARK.json`` keeps the benchmark's rules.

The tiny cells are the benchmark's configurations cut to a few sources,
two zonal wavenumbers, two days and a 36 x 19 grid, written with the
traffic mixes and the cells' limits into a temporary checkout
(``tiny_root``). The port runs its plain paths on the CPU (the kernels'
bit-for-bit versions); on a CUDA card the control test also runs there
(``device``).
"""

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from portbench import check, control, run, spec

HERE = Path(__file__).resolve().parent.parent
ROOT = HERE.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def tiny(config: dict, **run_changes) -> dict:
    config = json.loads(json.dumps(config))
    if config["run"].get("bound_mode") == "dense":
        config["run"]["interval_batch"] = 12
    config["run"].update(zwn=[1.0, 2.0], ttotal=2 * 86400.0, **run_changes)
    if config["sources"]["kind"] == "random":
        config["sources"]["count"] = 8
    else:
        config["run"].update(nnx=4, nny=2)
    config["grid"] = {"nlon": 36, "nlat": 19}
    return config


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    """A checkout holding the tiny cells and nothing of the program: the
    benchmark's traffic files and metric readers, tiny configurations,
    one new traffic mix, and a BENCHMARK.json naming them."""
    root = tmp_path_factory.mktemp("checkout")
    pb = root / "portbench"
    shutil.copytree(HERE / "traffic", pb / "traffic")
    shutil.copytree(HERE / "metrics", pb / "metrics")
    (pb / "configs").mkdir()
    (pb / "limits").mkdir()
    cells, configs = [], []
    for c in BENCH["configs"]:
        name = "tiny_" + c["name"]
        cfg = tiny(json.loads((ROOT / c["file"]).read_text()))
        (pb / "configs" / f"{name}.json").write_text(json.dumps(cfg))
        configs.append(dict(c, name=name,
                            file=f"portbench/configs/{name}.json"))
    for w in BENCH["workloads"]:
        cells.append(dict(w, name="tiny_" + w["name"],
                          config="tiny_" + w["config"]))
        shutil.copy(HERE / "limits" / f"{w['name']}.json",
                    pb / "limits" / f"tiny_{w['name']}.json")
    # A cell added as data alone: a new traffic mix (two members over
    # three daily frames) under an existing configuration.
    new = {"request": "trace_rays_ensemble", "clients": 1,
           "background": {"frames": 3, "frame_dt_s": 86400.0,
                          "season": 0.1, "period_days": 30.0,
                          "drift_deg_per_day": 2.0,
                          "members": [{"scale": 0.9}, {"scale": 1.1,
                                                       "phase_deg": 45.0}]}}
    (pb / "traffic" / "daily3x2.json").write_text(json.dumps(new))
    cells.append({"name": "tiny_new.daily3x2",
                  "config": "tiny_" + BENCH["configs"][0]["name"],
                  "traffic": "daily3x2", "chips": 1, "why": "added as data"})
    shutil.copy(HERE / "limits" / f"{BENCH['workloads'][0]['name']}.json",
                pb / "limits" / "tiny_new.daily3x2.json")
    bench = dict(BENCH, configs=configs, workloads=cells)
    bench["per_layer"] = [{k: v for k, v in m.items() if k != "workloads"}
                          for m in BENCH["per_layer"]]
    bench["end_to_end"] = [{k: v for k, v in m.items() if k != "workloads"}
                           for m in BENCH["end_to_end"]]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def run_cell(root, name, capsys, seed=3, seconds=0.5, trace=0):
    rc = run.main(["--workload", name, "--seed", str(seed), "--seconds",
                   str(seconds), "--trace", str(trace)], device="cpu",
                  root=root)
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    return json.loads(out[-1])


def test_a_cell_added_as_data_runs_correct(tiny_root, capsys):
    res = run_cell(tiny_root, "tiny_new.daily3x2", capsys)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    assert set(res["metrics"]) == {m["name"] for m in BENCH["end_to_end"]}
    assert list(res)[-1] == "checks"
    assert all(c["value"] <= c["limit"] for c in res["checks"].values())


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_runs_correct_at_a_tiny_size(tiny_root, capsys, cell):
    res = run_cell(tiny_root, "tiny_" + cell, capsys)
    assert res["correct"], res["checks"]
    assert res["metrics"]["ray_steps_per_s"]["value"] > 0


def test_a_traced_run_reads_the_trace(tiny_root, capsys):
    res = run_cell(tiny_root, "tiny_" + BENCH["workloads"][0]["name"],
                   capsys, trace=1)
    assert res["correct"], res["checks"]
    assert res["device"]["window_s"] > 0
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert list(res)[-1] == "checks"


def _broken(monkeypatch, fault):
    """Break the port's timed path under ``trace_rays``: the integration's
    rows, after the run."""
    from rwrt_tpu_torch import tracer

    real = tracer._run_lanes
    calls = []

    def broken(bg, y0, ug0, vg0, config, *a, **kw):
        ys, ugs, vgs = real(bg, y0, ug0, vg0, config, *a, **kw)
        ys = ys.clone()
        calls.append(1)
        if fault == "later_request_altered":
            # Two warm-up requests and the window's first are sound.
            if len(calls) > 3:
                ys[-1, 0] += 1e-3
        elif fault == "state_unchanged":
            ys[1:] = ys[0]
        elif fault == "half_left_out":
            ys[1:, :, ys.shape[-1] // 2:] = float("nan")
        elif fault == "answer_altered":
            # One value of one ray, where the integration produced it.
            lane = int(torch.nonzero(torch.isfinite(ys[-1, 0]))[0])
            ys[-1, 0, lane] += 1e-3
        return ys, ugs, vgs

    monkeypatch.setattr(tracer, "_run_lanes", broken)


def _failing(res):
    return [k for k, c in res["checks"].items() if c["value"] > c["limit"]]


@pytest.mark.parametrize("fault", ["state_unchanged", "half_left_out",
                                   "answer_altered"])
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_faults_come_out_not_correct(tiny_root, capsys, monkeypatch, fault,
                                     cell):
    _broken(monkeypatch, fault)
    res = run_cell(tiny_root, "tiny_" + cell, capsys)
    assert not res["correct"]
    assert _failing(res) == ["step_gap"]


def test_a_later_request_gone_wrong_is_not_correct(tiny_root, capsys,
                                                   monkeypatch):
    _broken(monkeypatch, "later_request_altered")
    res = run_cell(tiny_root, "tiny_" + BENCH["workloads"][0]["name"],
                   capsys, seconds=1.5)
    assert res["attempted"] >= 4 and not res["correct"]
    assert _failing(res) == ["step_gap"]


@pytest.fixture(params=["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def device(request):
    if request.param == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return request.param


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_control_comes_out_not_correct(tiny_root, capsys, device, cell):
    rc = control.main(["--workload", "tiny_" + cell, "--seeds", "4,5",
                       "--device", device], root=tiny_root)
    assert rc == 0
    lim = json.loads((tiny_root / "portbench" / "limits"
                      / f"tiny_{cell}.json").read_text())
    for line in capsys.readouterr().out.strip().splitlines():
        got = json.loads(line)
        over = [k for k, v in lim.items() if got["readings"][k] > v]
        assert over if got["side"] == "control" else not over, got


def test_no_card_no_result(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", BENCH["workloads"][0]["name"], "--seed",
                   "1", "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_benchmark_files_alone_give_no_result(tmp_path):
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(BENCH))
    shutil.copytree(HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, *BENCH["command"], "--workload",
                          BENCH["workloads"][0]["name"], "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True)
    assert out.returncode != 0 and out.stdout == ""
def test_benchmark_json_keeps_the_rules():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert (runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200) <= 43200
    names = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and (ROOT / c["file"]).is_file()
        assert all(NAME.match(k) for k in c["reduced"])
        names.add(c["name"])
    cells = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["config"] in names
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (HERE / "traffic" / f"{w['traffic']}.json").is_file()
        assert check.limits(HERE, w["name"])
        cells.add(w["name"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] == "host_clock"
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and callable(spec.reader(m["name"]))
        if m["unit"] == "%" and "roofline" in m["name"]:
            assert m["name"].endswith("_roofline")
