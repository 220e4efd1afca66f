"""The modules a run may not hold: JAX, its libraries and the JAX package.

Names are compared whole by their top-level part (before the first dot),
so the port, ``rwrt_tpu_torch``, whose name begins with the JAX package's,
is not one of them. The reference may not hold the port either
(``REFERENCE_FORBIDDEN``).
"""

from __future__ import annotations

import ast
from pathlib import Path
from typing import Iterable, List

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "rwrt_tpu"})
REFERENCE_FORBIDDEN = FORBIDDEN | {"rwrt_tpu_torch"}


def top_level(name: str) -> str:
    return name.split(".", 1)[0]


def forbidden(modules: Iterable[str], names=FORBIDDEN) -> List[str]:
    """The modules among ``modules`` (e.g. ``sys.modules``) whose
    top-level name is one of ``names``, sorted."""
    return sorted(m for m in modules if top_level(m) in names)


def imported_names(path: Path) -> List[str]:
    """The modules a Python source file imports (absolute imports)."""
    tree = ast.parse(path.read_text(), str(path))
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.append(node.module)
    return out
