"""No module of the benchmark imports JAX or the JAX package, and the
plain reference imports nothing of the program either.  Top-level names
are compared whole: the program's name begins with the JAX package's."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
JAX_NAMES = {"jax", "jaxlib", "flax", "minkowskiengine_tpu"}
PROGRAM = "minkowskiengine_tpu_torch"
MODULES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.relative_to(BENCH).parts)


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module":
            arg = node.args[0] if node.args else None
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                names.add(arg.value.split(".")[0])
    return names


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    assert not top_level_imports(path) & JAX_NAMES


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert PROGRAM not in top_level_imports(path)
    assert PROGRAM not in path.read_text()


def test_the_guard_compares_whole_names(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import minkowskiengine_tpu_torch as mt\nfrom jax import numpy\n")
    assert top_level_imports(f) == {"minkowskiengine_tpu_torch", "jax"}
    assert top_level_imports(f) & JAX_NAMES == {"jax"}


def test_a_run_loads_no_jax():
    """The harness, every traffic kind and reference, and the program,
    imported in a fresh process, bring no JAX in."""
    code = (
        "import sys; sys.path.insert(0, sys.argv[1]);"
        "import minkowskiengine_tpu_torch;"
        "from portbench import control, harness;"
        "import portbench.traffic.seg_train, portbench.traffic.seg_infer,"
        " portbench.traffic.completion_train;"
        "import portbench.reference.minkunet34, portbench.reference.completionnet;"
        "print(','.join(harness.forbidden_modules()))"
    )
    out = subprocess.run([sys.executable, "-c", code, str(BENCH.parent)], capture_output=True,
                         text=True, timeout=300, check=True)
    assert out.stdout.strip() == ""
