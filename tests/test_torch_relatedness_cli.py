"""bin/kpop-twistdb-torch (-s, -d) and bin/kpop-countdb-torch (--distances)
on the CPU via KPOP_PLATFORM=cpu, against the JAX CLIs on the same files.

The queries are the targets themselves, as `kpop-twistdb -s` is run on one
set, so every row holds a self-distance.  In float32 the expansion
|a|^2 + |b|^2 - 2 a.b of two unit-norm rows keeps an absolute error of a
few 1e-6 in d^2, which is up to about 1.4e-3 in d near 0 (for either
package: the JAX device path prints such values too).  So distances are
held to the bound of tests/test_device_summaries.py on d^2: rtol 4e-5
(twice its 2e-5 on d) and atol 4e-6.  Summaries: identical names and
targets, mean, std, median and MAD within 2e-4 * max(1, |x|), listed
distances by the d^2 bound (the z-scores are checked against the host in
tests/test_torch_summaries.py).  The help texts are the JAX CLIs' except
for the lines of --backend, and the port runs without importing JAX."""

import io
import os
import subprocess
import sys

import numpy as np
import pytest

from kpop_tpu.core.count import spectrum_of_sequences
from kpop_tpu.core.counter_db import CounterDB
from kpop_tpu.core.kmers import KmerSpace
from kpop_tpu.core.matrix import KPopMatrix, MatrixType

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BIN = os.path.join(REPO, "bin")
BACKENDS = ["jax", "pallas"]


def sh(cmd: str, cwd, check=True):
    env = dict(os.environ)
    env["PATH"] = BIN + os.pathsep + env["PATH"]
    env["PYTHONPATH"] = REPO
    env["KPOP_PLATFORM"] = "cpu"
    env["JAX_PLATFORMS"] = "cpu"
    res = subprocess.run(
        ["bash", "-c", cmd], cwd=str(cwd), env=env, capture_output=True, text=True
    )
    if check:
        assert res.returncode == 0, f"cmd failed: {cmd}\n{res.stderr[-3000:]}"
    return res


@pytest.fixture(scope="module")
def db(tmp_path_factory):
    """The 6-spectrum DB of tests/test_device_summaries.py and its twister."""
    td = tmp_path_factory.mktemp("relatedness_torch")
    rng = np.random.default_rng(2)
    space = KmerSpace("DNA-ds", 5)
    counter = CounterDB()
    for c in range(6):
        seq = "".join(np.array(list("ACGT"))[rng.integers(0, 4, 300)])
        codes, counts = spectrum_of_sequences(space, [seq])
        counter.add_spectra_stream(io.StringIO(
            "\tS%d\n" % c + "".join(
                "%s\t%d\n" % (space.code_to_hex(cd), ct)
                for cd, ct in zip(codes, counts))))
    counter.to_binary(str(td / "DB"))
    sh("kpop-twist -i DB -o TW", td)
    sh("kpop-twistdb -i T TW -i t TW -s TW HOST", td)
    return td


def summary_lines(path):
    return path.read_text().splitlines()


def assert_squared_close(got, want):
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    np.testing.assert_allclose(got**2, want**2, rtol=4e-5, atol=4e-6)


def assert_summaries_match(got, want):
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        pg, pw = g.split("\t"), w.split("\t")
        assert len(pg) == len(pw) and pg[0] == pw[0] and pg[5::3] == pw[5::3], (g, w)
        for a, b in zip(pg[1:5], pw[1:5]):
            assert abs(float(a) - float(b)) < 2e-4 * max(1.0, abs(float(b))), (g, w)
        assert_squared_close([float(x) for x in pg[6::3]], [float(x) for x in pw[6::3]])


def dmatrix(path):
    return KPopMatrix.of_binary(MatrixType.DMATRIX, str(path)).matrix


def assert_dmatrix_match(got, want):
    assert got.row_names == want.row_names and got.col_names == want.col_names
    assert_squared_close(got.data, want.data)


@pytest.mark.parametrize("backend", BACKENDS)
def test_twistdb_summaries_match_jax_cli(db, backend):
    sh(f"kpop-twistdb-torch -i T TW -i t TW --backend {backend} -s TW T_{backend}", db)
    sh(f"kpop-twistdb -i T TW -i t TW --backend {backend} -s TW J_{backend}", db)
    got = summary_lines(db / f"T_{backend}.KPopSummary.txt")
    assert_summaries_match(got, summary_lines(db / f"J_{backend}.KPopSummary.txt"))
    assert_summaries_match(got, summary_lines(db / "HOST.KPopSummary.txt"))


@pytest.mark.parametrize("backend", BACKENDS)
def test_twistdb_distances_match_jax_cli(db, backend):
    sh(f"kpop-twistdb-torch -i T TW -i t TW --backend {backend} -d TW -o d TD_{backend}", db)
    sh(f"kpop-twistdb -i T TW -i t TW --backend {backend} -d TW -o d JD_{backend}", db)
    sh("kpop-twistdb -i T TW -i t TW -d TW -o d HD", db)
    got = dmatrix(db / f"TD_{backend}")
    assert_dmatrix_match(got, dmatrix(db / f"JD_{backend}"))
    assert_dmatrix_match(got, dmatrix(db / "HD"))


@pytest.mark.parametrize("backend", BACKENDS)
def test_countdb_distances_match_jax_cli(db, backend):
    sel = "'~S[0-3]' '~.'"
    sh(f"kpop-countdb-torch -i DB --backend {backend} --distances {sel} TC_{backend}", db)
    sh(f"kpop-countdb -i DB --backend {backend} --distances {sel} JC_{backend}", db)
    sh(f"kpop-countdb -i DB --distances {sel} HC", db)
    got = dmatrix(db / f"TC_{backend}")
    assert got.data.shape == (6, 4)
    assert_dmatrix_match(got, dmatrix(db / f"JC_{backend}"))
    assert_dmatrix_match(got, dmatrix(db / "HC"))


def test_host_backend_is_the_jax_tools_output(db):
    sh("kpop-twistdb-torch -i T TW -i t TW --backend host -s TW T_host -d TW -o d TD_host", db)
    assert (db / "T_host.KPopSummary.txt").read_bytes() == (
        db / "HOST.KPopSummary.txt"
    ).read_bytes()
    sh("kpop-countdb-torch -i DB --distance 'minkowski(1)' --backend pallas "
       "--distances '~.' '~.' TC_mink", db)
    sh("kpop-countdb -i DB --distance 'minkowski(1)' --distances '~.' '~.' HC_mink", db)
    assert np.array_equal(dmatrix(db / "TC_mink").data, dmatrix(db / "HC_mink").data)


def help_without_backend(text: str) -> list[str]:
    """The help lines, without the option --backend and its description."""
    out, skip = [], False
    for line in text.splitlines():
        if line.strip().startswith("--backend"):
            skip = True
            continue
        if skip and line.startswith("    ") and not line.strip().startswith("-"):
            continue
        skip = False
        out.append(line)
    return out


@pytest.mark.parametrize("tool", ["twistdb", "countdb"])
def test_help_equals_jax_cli_but_backend(db, tool):
    res = sh(f"kpop-{tool}-torch -h", db)
    port = res.stdout + res.stderr
    res = sh(f"kpop-{tool} -h", db)
    ref = res.stdout + res.stderr
    assert "--backend" in port and "hand CUDA" in port
    assert port != ref
    assert help_without_backend(port) == help_without_backend(ref)


def test_relatedness_port_runs_without_jax(db):
    code = (
        "import sys\n"
        "from kpop_tpu_torch.cli import countdb, twistdb\n"
        "twistdb.main(['-i', 'T', 'TW', '-i', 't', 'TW', '--backend', 'pallas',"
        " '-s', 'TW', 'NoJax', '-d', 'TW', '-o', 'd', 'NoJaxD'])\n"
        "countdb.main(['-i', 'DB', '--backend', 'pallas', '--distances', '~.',"
        " '~.', 'NoJaxC'])\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "print('no-jax-ok')\n"
    )
    res = sh(f"{sys.executable} -c \"{code}\"", db)
    assert "no-jax-ok" in res.stdout
    assert len(summary_lines(db / "NoJax.KPopSummary.txt")) == 6
    assert dmatrix(db / "NoJaxC").data.shape == (6, 6)
