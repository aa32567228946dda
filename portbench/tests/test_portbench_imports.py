"""No module under portbench/ imports JAX or the JAX package, compared by
whole top-level name (the port's name begins with the JAX package's), and
the reference imports nothing of the port."""

from __future__ import annotations

import ast
import os

import pytest

from portbench.tests.tiny import BENCH

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "nerf_for_angiography_tpu"}
PORT = "nerf_for_angiography_tpu_torch"


def _modules(root):
    for d, _, files in os.walk(root):
        if "build" in os.path.relpath(d, root).split(os.sep):
            continue
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _imported(path):
    tree = ast.parse(open(path).read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module)
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                names.add(node.args[0].value)
    return {n.split(".", 1)[0] for n in names}


MODULES = sorted(_modules(BENCH))


def test_the_scan_sees_every_module():
    rel = {os.path.relpath(p, BENCH) for p in MODULES}
    assert {"run.py", "check.py", "counts.py", "reference/steps.py",
            "metrics/step_mfu.py", "steps_profile.py", "reference/encodings/none.py",
            "reference/encodings/fourier.py", "reference/encodings/barf.py"} <= rel


@pytest.mark.parametrize("path", MODULES, ids=lambda p: os.path.relpath(p, BENCH))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not _imported(path) & FORBIDDEN


def test_whole_names_tell_the_port_from_the_jax_package():
    assert PORT.split(".", 1)[0] not in FORBIDDEN
    assert "nerf_for_angiography_tpu" in FORBIDDEN


@pytest.mark.parametrize("path", [p for p in MODULES if os.sep + "reference" + os.sep in p],
                         ids=os.path.basename)
def test_the_reference_imports_nothing_of_the_port(path):
    assert PORT not in _imported(path)
    assert _imported(path) <= {"__future__", "importlib", "math", "os", "typing", "numpy",
                               "torch"}
