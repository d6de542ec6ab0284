"""No run loads JAX or the JAX package; the reference loads nothing of
the port.  Each check runs in a fresh interpreter: the repository's test
configuration itself imports jax."""

import ast
import os
import subprocess
import sys

import pytest

from portbench.harness import run_cell, spec

REFERENCE = os.path.join(spec.HERE, "reference")


def _fresh(code):
    env = dict(os.environ, PYTHONPATH=spec.ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.strip().splitlines()[-1]


@pytest.mark.parametrize("name", ["chem3_dust.blocks4k",
                                  "tabulated_uvb.one_cell"])
def test_a_run_loads_no_jax(name):
    found = _fresh(
        "import time\n"
        "from portbench.harness import run_cell, spec\n"
        "from portbench.tests import helpers\n"
        f"helpers.rehearse({name!r}, trace=True)\n"
        "print(sorted({m.split('.')[0] for m in __import__('sys').modules}"
        "))\n")
    top = set(eval(found))
    assert "grackle_tpu_torch" in top  # the run drove the port
    assert not top & set(run_cell.FORBIDDEN), top & set(run_cell.FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    found = _fresh(
        "import sys\n"
        "import portbench.reference.solve\n"
        "import portbench.yardstick.synthetic\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    top = set(eval(found))
    assert not top & {"grackle_tpu_torch", "grackle_tpu", "jax", "jaxlib",
                      "flax"}


def _imports(path):
    with open(path) as fh:
        tree = ast.parse(fh.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_reference_source_names_the_program_or_jax():
    for folder, _, files in os.walk(REFERENCE):
        for name in files:
            if name.endswith(".py"):
                for module in _imports(os.path.join(folder, name)):
                    assert module.split(".")[0] in (
                        "numpy", "torch", "math", "dataclasses", "typing",
                        "__future__"), (name, module)


def test_forbidden_names_are_whole_top_level_names():
    added = {"grackle_tpu_torch_extra": sys, "jaxlike.sub": sys}
    try:
        sys.modules.update(added)
        found = run_cell.forbidden_modules()
        assert "grackle_tpu_torch_extra" not in found
        assert "jaxlike" not in found
        sys.modules["grackle_tpu.api"] = sys
        assert "grackle_tpu" in run_cell.forbidden_modules()
    finally:
        for key in list(added) + ["grackle_tpu.api"]:
            sys.modules.pop(key, None)
