"""bin/kpop-twist-torch on the quick start (README.md), on the CPU via
KPOP_PLATFORM=cpu: ``--backend jax`` (the port's device CA) against
``kpop-twist --backend jax`` and ``--backend host`` within the bounds of
tests/test_dd.py:81-84, columns up to sign; ``--backend host`` equal to
``kpop-twist``'s files; and the whole quick start trained and served by the
port (kpop-twist-torch, then kpop-classify-torch) with 0 misclassified."""

import os
import subprocess
import sys

import numpy as np
import pytest

from kpop_tpu.core.matrix import KPopMatrix, MatrixType
from kpop_tpu.core.twister import Twister

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BIN = os.path.join(REPO, "bin")
DATA_GEN = os.path.join(REPO, "tests", "data", "make_clusters.py")
K = 5
SV_ATOL = 1e-8  # tests/test_dd.py:81-82 (inertia)
COORDS_ATOL = 1e-6  # tests/test_dd.py:83
TWISTER_ATOL = 1e-5  # tests/test_dd.py:84


def sh(cmd: str, cwd):
    env = dict(os.environ)
    env["PATH"] = BIN + os.pathsep + env["PATH"]
    env["PYTHONPATH"] = REPO
    env["KPOP_PLATFORM"] = "cpu"
    env.setdefault("JAX_PLATFORMS", "cpu")
    res = subprocess.run(["bash", "-c", cmd], cwd=str(cwd), env=env, capture_output=True, text=True)
    assert res.returncode == 0, f"cmd failed: {cmd}\n{res.stderr[-3000:]}"
    return res


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The quick start's counts, and twisters from the JAX tool (host and
    jax backends) and the port (host and jax backends, with -K)."""
    td = tmp_path_factory.mktemp("quickstart_twist_torch")
    sh(f"{sys.executable} {DATA_GEN} clusters-small.fasta", td)
    classes = " ".join("C%d" % i for i in range(1, 11))
    sh(
        "for CLASS in %s; do cat clusters-small.fasta | "
        "awk -v CLASS=$CLASS '{nr=(NR-1)%%4; ok=(nr==0?$0~(\"-\"CLASS\"$\"):nr==1&&ok); if (ok) print}' | "
        "kpop-count -k %d -L -f /dev/stdin | "
        "kpop-countdb -k /dev/stdin -R '~.' -A $CLASS -L $CLASS -N -D -t /dev/stdout; done | "
        "kpop-countdb -k /dev/stdin -o Classes" % (classes, K),
        td,
    )
    sh("kpop-twist -i Classes -o Host -K HostK", td)
    sh("kpop-twist --backend jax -i Classes -o Jax -K JaxK", td)
    sh("kpop-twist-torch -i Classes -o TorchHost -K TorchHostK", td)
    sh("kpop-twist-torch --backend jax -i Classes -o Torch -K TorchK", td)
    sh(
        "cat clusters-small.fasta | "
        "awk '{nr=(NR-1)%4; if (nr==2) split($0,s,\"[>-]\"); if (nr==3) print \">\"s[2]\"-\"s[3]\"\\n\"$0}' "
        "> test_seqs.fasta",
        td,
    )
    return td


def load(td, prefix):
    tw = Twister.of_binary(str(td / prefix))
    twisted = KPopMatrix.of_binary(MatrixType.TWISTED, str(td / prefix)).matrix
    kmers = KPopMatrix.of_binary(MatrixType.TWISTED, str(td / (prefix + "K"))).matrix
    return tw, twisted, kmers


@pytest.mark.parametrize("ref", ["Host", "Jax"])
def test_twist_torch_device_ca_matches_jax_tool(trained, ref):
    got_tw, got_twisted, got_k = load(trained, "Torch")
    want_tw, want_twisted, want_k = load(trained, ref)
    assert got_tw.kmer_names == want_tw.kmer_names and got_tw.dim_names == want_tw.dim_names
    assert got_twisted.row_names == want_twisted.row_names
    assert got_k.row_names == want_k.row_names
    np.testing.assert_allclose(
        got_tw.inertia.matrix.data, want_tw.inertia.matrix.data, rtol=0, atol=SV_ATOL
    )
    t_got, t_want = got_tw.twister.matrix.data, want_tw.twister.matrix.data  # [d, K]
    for j in range(len(got_tw.dim_names)):
        a, b = got_twisted.data[:, j], want_twisted.data[:, j]
        sign = 1.0 if np.dot(a, b) >= 0 else -1.0
        np.testing.assert_allclose(a, sign * b, rtol=0, atol=COORDS_ATOL)
        np.testing.assert_allclose(t_got[j], sign * t_want[j], rtol=0, atol=TWISTER_ATOL)
        np.testing.assert_allclose(got_k.data[:, j], sign * want_k.data[:, j], rtol=0, atol=TWISTER_ATOL)


@pytest.mark.parametrize("suffix", [".KPopTwister", ".KPopTwisted", "K.KPopTwisted"])
def test_twist_torch_host_backend_writes_the_jax_tool_files(trained, suffix):
    prefix = "Host" + suffix if suffix.startswith(".") else "HostK.KPopTwisted"
    mine = "TorchHost" + suffix if suffix.startswith(".") else "TorchHostK.KPopTwisted"
    assert (trained / mine).read_bytes() == (trained / prefix).read_bytes()


def test_quick_start_trained_and_served_by_the_port(trained):
    sh(
        "kpop-classify-torch -T Torch -t Torch -f test_seqs.fasta -k %d -o Pred" % K,
        trained,
    )
    lines = (trained / "Pred.KPopSummary.txt").read_text().splitlines()
    assert len(lines) == 100
    wrong = sum(ln.split("\t")[0].split("-")[1] != ln.split("\t")[5] for ln in lines)
    assert wrong == 0
