"""No module of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the port (top-level names compared whole)."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "kpop_tpu", "bench", "benchmarks"}


def imports(path: Path) -> set[str]:
    """Top-level names of every module that ``path`` imports (relative
    imports resolved to ``portbench``)."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            out.add("portbench" if node.level else node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            arg = node.args[0] if node.args else None
            if isinstance(arg, ast.Constant):
                out.add(arg.value.split(".")[0])
    return out


SOURCES = sorted(ROOT.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax(path):
    assert not imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((ROOT / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert imports(path) <= {"__future__", "portbench", "numpy", "torch", "math", "re",
                             "contextlib"}


def test_scan_sees_a_forbidden_import(tmp_path):
    """The scan is no blind test: it finds each kind of import."""
    p = tmp_path / "m.py"
    p.write_text("import jax.numpy\nfrom kpop_tpu.ops import x\n"
                 "importlib.import_module('flax.linen')\nimport kpop_tpu_torch\n")
    assert imports(p) == {"jax", "kpop_tpu", "flax", "kpop_tpu_torch"}
    assert not {"kpop_tpu_torch"} & FORBIDDEN


def test_run_refuses_a_loaded_jax_package(monkeypatch):
    import sys
    import types

    from portbench import harness

    monkeypatch.setitem(sys.modules, "kpop_tpu.ops", types.ModuleType("kpop_tpu.ops"))
    assert "kpop_tpu.ops" in harness.forbidden_modules()
