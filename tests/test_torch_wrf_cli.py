"""The port's WRF file driver against the JAX package's.

``rwrt_tpu.diagnostics.wrf_cli.main`` and
``rwrt_tpu_torch.diagnostics.wrf_cli.main([..., "--device", "cpu"])`` on
the same trajectory files (written by the JAX package's writer from
tests/test_torch_flux.py's synthetic trajectories, float64): one file, two
files pooled, ``--ensemble-stats``, ``--time-block``, with and without a
target region and thresholds.

Bars: the same .npz members; ``count`` maps (and ``first_entry_step``,
``n_passing``) equal; every other member within 1e-12 of its largest
magnitude, NaN masks equal; the printed JSON line and the ``wrote`` line
the same but for the path.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rwrt_tpu.diagnostics import wrf_cli as jcli
from rwrt_tpu.io import ncio as jio
from rwrt_tpu.tracer import RayTrajectories as JTraj
from rwrt_tpu_torch.diagnostics import wrf_cli as pcli
from test_torch_flux import FIELDS, synthetic

BAR = 1e-12
EXACT = ("count", "count_mean", "first_entry_step", "n_passing", "lon",
         "lat", "source_lon", "source_lat")


def traj_file(tmp_path, seed, name):
    d = synthetic(seed)
    path = str(tmp_path / f"{name}.npz")
    jio.write_trajectories(JTraj(**{k: jnp.asarray(d[k]) for k in FIELDS}),
                           path, np.array([1.0, 2.0, 3.0, 4.0]))
    return path


def run_both(tmp_path, capsys, files, flags):
    """Both CLIs on ``files``; returns their output files' contents and
    their printed lines (the output path cut from the ``wrote`` line)."""
    outs = []
    for name, main, extra in (("jax", jcli.main, []),
                              ("port", pcli.main, ["--device", "cpu"])):
        out = str(tmp_path / f"{name}_wrf.npz")
        assert main(["--traj", *files, "--out", out] + flags + extra) == 0
        lines = capsys.readouterr().out.strip().splitlines()
        lines[-1] = lines[-1].replace(out, "OUT")
        with np.load(out) as ds:
            outs.append(({k: ds[k] for k in ds.files}, lines))
    return outs


def files_close(want, got):
    assert sorted(want) == sorted(got)
    for k, a in want.items():
        b = got[k]
        assert a.shape == b.shape, k
        if a.dtype.kind != "f" or k in EXACT:
            np.testing.assert_array_equal(a, b, err_msg=k)
            continue
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=k)
        scale = max(np.nanmax(np.abs(a), initial=0.0), 1e-300)
        np.testing.assert_allclose(b, a, rtol=0, atol=BAR * scale,
                                   equal_nan=True, err_msg=k)


REGION = ["--lon-range", "100", "300", "--lat-range", "-40", "40"]
CASES = {
    "one_file": (1, []),
    "one_file_region": (1, REGION + ["--speed-max", "45", "--mwn-max",
                                     "90", "--weight", "count"]),
    "two_files": (2, REGION + ["--nlon-bins", "72", "--nlat-bins", "30"]),
    "ensemble_stats": (2, ["--ensemble-stats", "--weight", "cg"]),
    "ensemble_stats_region": (3, ["--ensemble-stats"] + REGION),
    "time_block": (1, ["--time-block", "7"] + REGION),
    "time_block_ensemble": (2, ["--time-block", "5", "--ensemble-stats",
                                "--amp-min", "0.5"] + REGION),
}


@pytest.mark.parametrize("case", list(CASES))
def test_wrf_cli_matches_jax(tmp_path, capsys, case):
    n, flags = CASES[case]
    files = [traj_file(tmp_path, 20 + i, f"traj{i}") for i in range(n)]
    (want, want_lines), (got, got_lines) = run_both(tmp_path, capsys, files,
                                                    flags)
    files_close(want, got)
    assert got_lines == want_lines
    if "--lon-range" in flags:
        assert json.loads(got_lines[0])["n_passing"] > 0


def test_load_ray_output_concatenates_and_checks_shapes(tmp_path):
    a = traj_file(tmp_path, 1, "a")
    b = traj_file(tmp_path, 2, "b")
    traj = pcli.load_ray_output([a, b], device="cpu")
    want = jcli.load_ray_output([a, b], device=False)
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(traj, k).numpy(),
                                      np.asarray(getattr(want, k)))
    d = synthetic(3, nt=12)
    short = str(tmp_path / "short.npz")
    jio.write_trajectories(JTraj(**{k: jnp.asarray(d[k]) for k in FIELDS}),
                           short, np.array([1.0, 2.0, 3.0, 4.0]))
    with pytest.raises(ValueError, match="share"):
        pcli.load_ray_output([a, short], device="cpu")


def test_wrf_cli_argument_errors(tmp_path):
    a = traj_file(tmp_path, 1, "a")
    out = str(tmp_path / "o.npz")
    with pytest.raises(SystemExit):
        pcli.main(["--traj", a, "--out", out, "--ensemble-stats",
                   "--device", "cpu"])
    with pytest.raises(SystemExit):
        pcli.main(["--traj", a, "--out", out, "--time-block", "0",
                   "--device", "cpu"])


def test_cuda_run_without_a_card_is_an_error(tmp_path):
    """The default device is the card; without one the driver raises and
    does not fall back to the host."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    a = traj_file(tmp_path, 1, "a")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pcli.main(["--traj", a, "--out", str(tmp_path / "o.npz")])
