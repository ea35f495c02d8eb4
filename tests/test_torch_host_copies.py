"""The port's copies of the JAX package's host modules are held to their
originals.

A module copied whole must have the same syntax tree once its imports are
normalised (relative imports resolved, ``kpop_tpu_torch`` read as
``kpop_tpu``) and its docstrings dropped.  The modules that differ on purpose are listed in DIFFERENT
and held otherwise: every top-level definition they share with the original
is the same, and what differs is checked by behaviour on seeded inputs."""

import ast
import os
import re

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WHOLE = [
    "utils/cli.py", "utils/naming.py", "utils/progress.py", "utils/quoting.py",
    "io/framed.py", "io/reads.py", "io/spectra.py",
    "core/kmers.py", "core/matrix.py", "core/space.py", "core/transforms.py",
    "core/counter_db.py", "core/splits.py", "core/count.py", "core/ca.py",
    "core/distance_iterator.py", "cli/twist.py", "cli/count.py",
]
#: copy -> (original, top-level names that differ on purpose)
DIFFERENT = {
    "core/twister.py": ("core/twister.py", {"twist_counter_db"}),
    "native/__init__.py": (
        "native/__init__.py", {"_LIB", "_build", "get_lib", "library_path", "_cpu_model"},
    ),
    "cli/classify.py": ("cli/classify.py", None),
    "cli/twistdb.py": ("cli/twistdb.py", None),
    "parallel/sharded.py": ("parallel/sharded.py", None),
    "ops/cuckoo.py": ("ops/cuckoo.py", None),
}
#: names the port's module copies from the original's, verbatim
SHARED = {
    "cli/classify.py": {"AmbiguousK", "infer_k"},
    "cli/twistdb.py": {"REGISTER_TYPES", "MATRIX_OF_REGISTER", "_register", "_parse_keep_at_most"},
    "parallel/sharded.py": {"_compact_exact_cast", "_factor_gram_host"},
    "ops/cuckoo.py": {"_MAX_ROUNDS", "_MAX_SEED_ATTEMPTS", "_mix_np", "_seeds", "build_cuckoo"},
}


class _Normalise(ast.NodeTransformer):
    """Resolve relative imports against the module's package, read the
    port's package name as the JAX package's, and drop docstrings (the
    copies cite the reference's sources by their paths in the reference
    project)."""

    def __init__(self, package: str):
        self.package = package

    def _drop_docstring(self, node):
        self.generic_visit(node)
        body = node.body
        if body and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant) \
                and isinstance(body[0].value.value, str):
            node.body = body[1:] or [ast.Pass()]
        return node

    visit_Module = visit_FunctionDef = visit_AsyncFunctionDef = visit_ClassDef = _drop_docstring

    def visit_ImportFrom(self, node):
        if node.level:
            base = self.package.split(".")[: len(self.package.split(".")) - node.level + 1]
            node.module = ".".join(base + ([node.module] if node.module else []))
            node.level = 0
        node.module = node.module.replace("kpop_tpu_torch", "kpop_tpu")
        return node

    def visit_Import(self, node):
        for a in node.names:
            a.name = a.name.replace("kpop_tpu_torch", "kpop_tpu")
        return node


def tree(pkg: str, rel: str) -> ast.Module:
    path = os.path.join(REPO, pkg, rel)
    module = ast.parse(open(path).read(), filename=path)
    package = ".".join([pkg] + rel.split("/")[:-1])
    return _Normalise(package).visit(module)


def top_level(module: ast.Module) -> dict[str, str]:
    """Dump of every top-level function, class and assignment by name."""
    out = {}
    for node in module.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            out[node.name] = ast.dump(node)
        elif isinstance(node, ast.Assign) and len(node.targets) == 1 and isinstance(node.targets[0], ast.Name):
            out[node.targets[0].id] = ast.dump(node)
    return out


class _BlankStrings(ast.NodeTransformer):
    def visit_Constant(self, node):
        return ast.Constant("") if isinstance(node.value, str) else node


@pytest.mark.parametrize("rel", WHOLE)
def test_whole_copy_has_the_original_tree(rel):
    got = tree("kpop_tpu_torch", rel)
    want = tree("kpop_tpu", rel)
    if rel == "cli/twist.py":
        # the same code; its docstring and --backend help name the port
        got, want = _BlankStrings().visit(got), _BlankStrings().visit(want)
    assert ast.dump(got) == ast.dump(want)


@pytest.mark.parametrize("rel", sorted(DIFFERENT))
def test_shared_definitions_equal_the_original(rel):
    orig, differ = DIFFERENT[rel]
    got = top_level(tree("kpop_tpu_torch", rel))
    want = top_level(tree("kpop_tpu", orig))
    names = SHARED.get(rel) or (set(got) & set(want)) - differ
    assert names, rel
    for name in sorted(names):
        assert got[name] == want[name], f"{rel}: {name} differs from kpop_tpu/{orig}"
    if differ is not None:
        assert (set(want) - set(got)) <= differ


def test_native_source_is_the_original():
    a = open(os.path.join(REPO, "kpop_tpu_torch", "native", "kpop_native.cpp"), "rb").read()
    b = open(os.path.join(REPO, "kpop_tpu", "native", "kpop_native.cpp"), "rb").read()
    assert a == b


def test_native_builds_into_the_port():
    from kpop_tpu_torch import native

    path = native.library_path()
    assert os.path.dirname(path) == os.path.join(REPO, "kpop_tpu_torch", "_build")
    if not native.available():
        pytest.skip("no C++ compiler: the port falls back to numpy")
    assert os.path.exists(path)


@pytest.mark.parametrize("case", ["encode_dna", "encode_protein", "batch", "count_dense", "format"])
def test_native_behaves_as_the_original(case):
    from kpop_tpu import native as want
    from kpop_tpu_torch import native as got

    if not (got.available() and want.available()):
        pytest.skip("native library unavailable")
    rng = np.random.default_rng(11)
    seqs = ["".join(rng.choice(list("ACGTNacgtRY"), size=int(n))) for n in rng.integers(1, 90, 7)]
    if case == "encode_dna":
        for s in seqs:
            np.testing.assert_array_equal(got.encode_dna(s.encode()), want.encode_dna(s.encode()))
    elif case == "encode_protein":
        for s in seqs:
            np.testing.assert_array_equal(got.encode_protein(s.encode()), want.encode_protein(s.encode()))
    elif case == "batch":
        for protein in (False, True):
            np.testing.assert_array_equal(
                got.encode_batch(seqs, protein, 64), want.encode_batch(seqs, protein, 64)
            )
    elif case == "count_dense":
        codes = got.encode_batch(seqs, False)
        for k, canonical in ((3, True), (5, False)):
            np.testing.assert_array_equal(
                got.count_dense_batch(codes, k, canonical), want.count_dense_batch(codes, k, canonical)
            )
    else:
        codes = np.sort(rng.choice(4**6, size=50, replace=False)).astype(np.int64)
        counts = rng.integers(1, 1000, size=50).astype(np.float64)
        assert got.format_spectra_entries(codes, counts, 3) == want.format_spectra_entries(codes, counts, 3)


def test_config_constant_equals_the_original():
    from kpop_tpu import config as want
    from kpop_tpu_torch import config as got

    assert got.DENSE_K_MAX == want.DENSE_K_MAX


@pytest.mark.parametrize(
    "labels,k", [(["0a3", "3ff"], 0), (["0a3", "3ff"], 5), (["0003f"], 0), (["ff"], 4)]
)
def test_infer_k_behaves_as_the_original(labels, k):
    from kpop_tpu.cli.classify import AmbiguousK as WantErr, infer_k as want
    from kpop_tpu_torch.cli.classify import AmbiguousK as GotErr, infer_k as got

    try:
        expected = want("DNA-ds", labels, k)
    except WantErr as e:
        with pytest.raises(GotErr, match=re.escape(str(e))):
            got("DNA-ds", labels, k)
    else:
        assert got("DNA-ds", labels, k) == expected


def test_twistdb_registers_behave_as_the_original():
    from kpop_tpu.cli import twistdb as want
    from kpop_tpu_torch.cli import twistdb as got

    assert got.REGISTER_TYPES == want.REGISTER_TYPES
    assert {k: v.name for k, v in got.MATRIX_OF_REGISTER.items()} == {
        k: v.name for k, v in want.MATRIX_OF_REGISTER.items()
    }
