"""The port's examples (``examples/torch_*.py``) beside the JAX package's.

Each port example runs at ``RWRT_SMOKE=1 --device cpu`` in a subprocess,
and its JAX counterpart at ``RWRT_SMOKE=1`` (as ``tests/test_examples.py``
runs it); the figures each prints are held to the JAX example's:

- great circle: the same alive count, max |lat| per zwn equal at the
  printed 0.1 degree; the plot script draws either package's file;
- flux: equal termination counts, binned-point counts (all, and the
  region-filtered) within 0.1 %;
- adjoint: both gradients within 1e-6 relative of JAX's;
- targeting: the objective history (first and last, as printed) within
  1e-5 relative, and each seed's end position as printed (marked slow).
"""

import os
import re
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(script, *argv, cwd, port=True, timeout=600, check=True):
    env = dict(os.environ, JAX_PLATFORMS="cpu", RWRT_SMOKE="1",
               PYTHONPATH=REPO)
    # Examples run single-device; drop any test-harness device forcing.
    env.pop("XLA_FLAGS", None)
    name = ("torch_" + script) if port else script
    args = [*argv, "--device", "cpu"] if port else list(argv)
    os.makedirs(cwd, exist_ok=True)
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "examples", name), *args],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=timeout,
    )
    if check:
        assert proc.returncode == 0, (
            f"{name} failed\nstdout:\n{proc.stdout}\nstderr:\n{proc.stderr}")
    return proc


def both(script, tmp_path, *argv):
    """The stdout of the port's example and of the JAX package's."""
    return (_run(script, *argv, cwd=tmp_path / "port").stdout,
            _run(script, *argv, cwd=tmp_path / "jax", port=False).stdout)


def numbers(pattern, text):
    m = re.search(pattern, text)
    assert m, f"{pattern!r} not in:\n{text}"
    return [float(x) for x in m.groups()]


def test_great_circle_demo_and_plot(tmp_path):
    port, ref = both("great_circle_demo.py", tmp_path)
    alive = r"integrated \((.*)\) trajectories; (\d+) alive at end"
    assert re.search(alive, port).groups() == re.search(alive, ref).groups()
    lats = r"max \|lat\| reached per zwn \(deg\): \[(.*)\]"
    assert re.search(lats, port).group(1).split() == re.search(
        lats, ref).group(1).split()
    # The plot script draws the port's file and the JAX package's.
    for tree in ("port", "jax"):
        traj = tmp_path / tree / "rays_great_circle.npz"
        png = tmp_path / f"{tree}.png"
        out = _run("plot_trajectories.py", str(traj), str(png),
                   cwd=tmp_path / "plot").stdout
        assert "wrote" in out and png.stat().st_size > 0


def test_flux_diagnostics_demo(tmp_path):
    port, ref = both("flux_diagnostics_demo.py", tmp_path)
    binned = r"trajectory points binned: ([\d,]+) \(region-filtered: ([\d,]+)\)"
    got = [int(x.replace(",", "")) for x in re.search(binned, port).groups()]
    want = [int(x.replace(",", "")) for x in re.search(binned, ref).groups()]
    assert all(abs(g - w) <= 1e-3 * w for g, w in zip(got, want)), (got,
                                                                     want)
    counts = r"termination counts: (\{.*\})"
    assert re.search(counts, port).group(1) == re.search(counts, ref).group(1)


def test_adjoint_sensitivity_demo(tmp_path):
    port, ref = both("adjoint_sensitivity.py", tmp_path)
    for what in ("jet scale", "seed lat"):
        pattern = (r"d\(final lat\)/d\(" + what
                   + r"\):\s+grad (\S+)\s+fd (\S+)")
        grad, fd = numbers(pattern, port)
        want, _ = numbers(pattern, ref)
        assert abs(grad - want) <= 1e-6 * abs(want), (what, grad, want)
        assert abs(grad - fd) <= 1e-6 * abs(fd), (what, grad, fd)
    lat = r"final latitude after 4 days: (\S+) deg"
    assert numbers(lat, port) == numbers(lat, ref)


@pytest.mark.slow
def test_source_targeting_demo(tmp_path):
    """Marked slow as the JAX pair's is: the two runs take over 60 s on
    the CPU (the port's optimizer about 40 of them)."""
    port, ref = both("source_targeting.py", tmp_path)
    history = r"objective: (\S+) -> (\S+) rad after (\d+) Adam steps"
    got, want = numbers(history, port), numbers(history, ref)
    assert got[2] == want[2] == 12
    assert all(abs(g - w) <= 1e-5 * abs(w) for g, w in zip(got, want))
    seeds = r"(seed \d: .*)"
    assert re.findall(seeds, port) == re.findall(seeds, ref)


def test_examples_need_a_card_unless_told_cpu(tmp_path):
    """Without ``--device`` an example goes to the card; with no card it
    fails and says to pass ``--device cpu`` (never falls back)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    env = dict(os.environ, PYTHONPATH=REPO, RWRT_SMOKE="1")
    for name in ("torch_great_circle_demo.py", "torch_adjoint_sensitivity.py"):
        proc = subprocess.run(
            [sys.executable, os.path.join(REPO, "examples", name)],
            cwd=tmp_path, env=env, capture_output=True, text=True,
            timeout=300)
        assert proc.returncode != 0
        assert "--device cpu" in proc.stderr
        assert not (tmp_path / "rays_great_circle.npz").exists()
