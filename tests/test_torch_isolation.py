"""The PyTorch port imports nothing of JAX or of the JAX package: statically
(every import statement of kpop_tpu_torch/, bin/*-torch, tools/ and
chip_smoke.py)
and at run time (a fresh interpreter imports every module and CLI of the
port and finds neither in sys.modules)."""

import ast
import glob
import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "kpop_tpu_torch")

SOURCES = sorted(
    os.path.relpath(p, REPO)
    for p in glob.glob(os.path.join(PKG, "**", "*.py"), recursive=True)
    + glob.glob(os.path.join(REPO, "bin", "*-torch"))
    + glob.glob(os.path.join(REPO, "tools", "*.py"))
    + [os.path.join(REPO, "chip_smoke.py")]
)
MODULES = sorted(
    os.path.splitext(p)[0].replace(os.sep, ".").removesuffix(".__init__")
    for p in SOURCES
    if p.startswith("kpop_tpu_torch") and p.endswith(".py")
)
CLI_MAINS = sorted(m for m in MODULES if m.startswith("kpop_tpu_torch.cli."))


def forbidden(name: str) -> bool:
    """jax, jaxlib, kpop_tpu and their submodules; not kpop_tpu_torch."""
    root = name.split(".")[0]
    return root in ("jax", "jaxlib", "kpop_tpu")


def absolute_imports(path: str) -> list[str]:
    """Every module an import statement of the file names; relative imports
    resolve inside the port, so they are left out."""
    tree = ast.parse(open(os.path.join(REPO, path)).read(), filename=path)
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    return names


def test_the_scan_sees_the_port():
    assert len(MODULES) > 30 and "kpop_tpu_torch.parallel.sharded" in MODULES
    assert {"bin/kpop-twist-torch", "tools/probe_ca_gram.py", "chip_smoke.py"} <= set(SOURCES)
    assert forbidden("kpop_tpu.core.ca") and forbidden("jax.numpy")
    assert not forbidden("kpop_tpu_torch.core.ca")


@pytest.mark.parametrize("path", SOURCES)
def test_no_jax_or_kpop_tpu_import(path):
    bad = [n for n in absolute_imports(path) if forbidden(n)]
    assert not bad, f"{path} imports {bad}"


@pytest.fixture(scope="module")
def loaded():
    """A fresh interpreter imports every module of the port and looks up
    every CLI's main; returns what sys.modules held of JAX or kpop_tpu
    after each."""
    code = (
        "import importlib, json, sys\n"
        "mods, clis = json.loads(sys.argv[1]), json.loads(sys.argv[2])\n"
        "seen = {}\n"
        "def bad():\n"
        "    return sorted(m for m in sys.modules\n"
        "                  if m.split('.')[0] in ('jax', 'jaxlib', 'kpop_tpu'))\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "    seen[m] = bad()\n"
        "for m in clis:\n"
        "    assert callable(importlib.import_module(m).main)\n"
        "    seen[m + ':main'] = bad()\n"
        "print(json.dumps(seen))\n"
    )
    env = dict(os.environ, KPOP_PLATFORM="cpu", PYTHONPATH=REPO)
    res = subprocess.run(
        [sys.executable, "-c", code, json.dumps(MODULES), json.dumps(CLI_MAINS)],
        capture_output=True, text=True, env=env, cwd=REPO,
    )
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("name", MODULES + [m + ":main" for m in CLI_MAINS])
def test_import_loads_no_jax_or_kpop_tpu(loaded, name):
    assert loaded[name] == [], f"importing {name} loaded {loaded[name]}"
