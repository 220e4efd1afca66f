"""Nothing the benchmark runs imports JAX, its libraries or the JAX package,
and the reference imports nothing of the port either: by the imports
written in the sources, and by what a process that loads the reference
holds."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import imports

HERE = Path(__file__).resolve().parent.parent
SOURCES = sorted(p for p in HERE.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(HERE)) for p in SOURCES])
def test_no_forbidden_imports(path):
    names = imports.imported_names(path)
    banned = (imports.REFERENCE_FORBIDDEN if "reference" in path.parts
              else imports.FORBIDDEN)
    assert not imports.forbidden(names, banned), path


def test_names_compare_whole():
    mods = ["rwrt_tpu_torch", "rwrt_tpu_torch.tracer", "jaxtyping",
            "rwrt_tpu.tracer", "jax.numpy", "jaxlib", "flax.linen",
            "numpy"]
    assert imports.forbidden(mods) == ["flax.linen", "jax.numpy", "jaxlib",
                                       "rwrt_tpu.tracer"]
    assert imports.forbidden(mods, imports.REFERENCE_FORBIDDEN) == [
        "flax.linen", "jax.numpy", "jaxlib", "rwrt_tpu.tracer",
        "rwrt_tpu_torch", "rwrt_tpu_torch.tracer"]


def test_reference_closure_holds_no_program():
    code = ("import sys, json\n"
            "import portbench.reference.rays, portbench.check\n"
            "print(json.dumps(sorted(sys.modules)))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=HERE.parent,
                         capture_output=True, text=True, check=True)
    held = json.loads(out.stdout.strip().splitlines()[-1])
    assert not imports.forbidden(held, imports.REFERENCE_FORBIDDEN)
