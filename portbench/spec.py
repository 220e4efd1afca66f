"""Find a cell's pieces by name: its entry in ``BENCHMARK.json``, its
configuration and traffic files, and the readers of its per-layer metrics.

Nothing here names a cell, a configuration, a traffic mix or a metric: a
cell added to ``BENCHMARK.json`` with files of its own under
``portbench/configs``, ``portbench/traffic`` and ``portbench/metrics`` is
found as these are.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Callable, List

HERE = Path(__file__).resolve().parent


def load_benchmark(root: Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_file(root: Path, bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return json.loads((root / c["file"]).read_text())
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic_file(name: str, here: Path = HERE) -> dict:
    return json.loads((here / "traffic" / f"{name}.json").read_text())


def metrics_of(bench: dict, kind: str, cell: str) -> List[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics a cell reports: those
    that list it, or list no cells."""
    return [m for m in bench[kind]
            if "workloads" not in m or cell in m["workloads"]]


def reader(name: str, here: Path = HERE) -> Callable:
    """The ``read(ctx)`` of ``portbench/metrics/<name>.py``."""
    path = here / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read

