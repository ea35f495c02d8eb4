"""bin/kpop-classify-torch on the quick start (README.md), on the CPU via
KPOP_PLATFORM=cpu: its summaries must match the multi-process chain
kpop-count | kpop-twistdb -k | kpop-twistdb -s field by field, with the
bound of tests/test_e2e_quickstart.py and 0 misclassified.  The port must
run without importing JAX."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BIN = os.path.join(REPO, "bin")
DATA_GEN = os.path.join(REPO, "tests", "data", "make_clusters.py")
K = 5


def sh(cmd: str, cwd, check=True):
    env = dict(os.environ)
    env["PATH"] = BIN + os.pathsep + env["PATH"]
    env["PYTHONPATH"] = REPO
    env["KPOP_PLATFORM"] = "cpu"
    env.setdefault("JAX_PLATFORMS", "cpu")
    res = subprocess.run(
        ["bash", "-c", cmd], cwd=str(cwd), env=env, capture_output=True, text=True
    )
    if check:
        assert res.returncode == 0, f"cmd failed: {cmd}\n{res.stderr[-3000:]}"
    return res


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The quick start's training steps and its multi-process prediction."""
    td = tmp_path_factory.mktemp("quickstart_torch")
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
    sh("kpop-twist -i Classes -o Classes", td)
    sh(
        "cat clusters-small.fasta | "
        "awk '{nr=(NR-1)%4; if (nr==2) split($0,s,\"[>-]\"); if (nr==3) print \">\"s[2]\"-\"s[3]\"\\n\"$0}' "
        "> test_seqs.fasta",
        td,
    )
    sh(
        "kpop-count -k %d -L -f test_seqs.fasta | "
        "kpop-twistdb -i T Classes -k /dev/stdin -o t /dev/stdout | "
        "kpop-twistdb -i T Classes -i t Classes -s /dev/stdin Reference" % K,
        td,
    )
    return td


def summaries(path):
    return sorted(path.read_text().splitlines())


@pytest.mark.parametrize("path", ["auto", "dense", "bag"])
def test_classify_torch_matches_multiprocess_chain(trained, path):
    out = "Torch_%s" % path
    sh(
        "kpop-classify-torch -T Classes -t Classes -f test_seqs.fasta "
        "--batch 32 --project-path %s -o %s" % (path, out),
        trained,
    )
    got = summaries(trained / (out + ".KPopSummary.txt"))
    ref = summaries(trained / "Reference.KPopSummary.txt")
    assert len(got) == len(ref) == 100
    misclassified = 0
    for lg, lr in zip(got, ref):
        pg, pr = lg.split("\t"), lr.split("\t")
        assert pg[0] == pr[0]
        assert pg[5] == pr[5], f"class mismatch: {pg[0]}: {pg[5]} != {pr[5]}"
        misclassified += pg[0].split("-")[1] != pg[5]
        for a, b in zip(pg[1:5], pr[1:5]):
            assert abs(float(a) - float(b)) < 1e-4 * max(1.0, abs(float(b)))
    assert misclassified == 0


def test_classify_torch_minkowski_host_path_equals_jax_cli(trained):
    args = "-T Classes -t Classes -f test_seqs.fasta --distance 'minkowski(1)'"
    sh("kpop-classify-torch %s -o MT" % args, trained)
    sh("kpop-classify %s -o MJ" % args, trained)
    assert summaries(trained / "MT.KPopSummary.txt") == summaries(
        trained / "MJ.KPopSummary.txt"
    )


@pytest.mark.parametrize(
    "option", ["--kmer-parallel 2"]
)
def test_classify_torch_unported_options_raise(trained, option):
    """``--kmer-parallel 2`` serves on one device as the JAX tool serves
    there (the name is from when the port raised on it): the same summary,
    bit for bit, as the port without the option, with a line under ``-v``
    that it has no effect; and within the bound of the other JAX
    comparisons of ``kpop-classify --kmer-parallel 2``, which shards the
    twister over the 8 host devices of tests/conftest.py."""
    args = "-T Classes -t Classes -f test_seqs.fasta"
    res = sh("kpop-classify-torch %s %s -v -o KP" % (args, option), trained)
    assert "has no effect on one device" in res.stderr
    sh("kpop-classify-torch %s -o K0" % args, trained)
    got = (trained / "KP.KPopSummary.txt").read_bytes()
    assert got == (trained / "K0.KPopSummary.txt").read_bytes()
    res = sh("kpop-classify %s %s -v -o KJ" % (args, option), trained)
    assert "(kmer-parallel 2)" in res.stderr
    mine, jax_lines = summaries(trained / "KP.KPopSummary.txt"), summaries(
        trained / "KJ.KPopSummary.txt")
    assert len(mine) == len(jax_lines) == 100
    for lg, lj in zip(mine, jax_lines):
        pg, pj = lg.split("\t"), lj.split("\t")
        assert pg[0] == pj[0] and pg[5] == pj[5]
        for a, b in zip(pg[1:5], pj[1:5]):
            assert abs(float(a) - float(b)) < 1e-4 * max(1.0, abs(float(b)))


def test_port_runs_without_jax(trained):
    code = (
        "import sys\n"
        "import kpop_tpu_torch.ops.pipeline, kpop_tpu_torch.cli.classify\n"
        "from kpop_tpu_torch.cli.classify import main\n"
        "main(['-T', 'Classes', '-t', 'Classes', '-f', 'test_seqs.fasta',"
        " '-o', 'NoJax', '--project-path', 'bag'])\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "print('no-jax-ok')\n"
    )
    res = sh(f"{sys.executable} -c \"{code}\"", trained)
    assert "no-jax-ok" in res.stdout
    assert len(summaries(trained / "NoJax.KPopSummary.txt")) == 100


def test_serve_loop_keeps_one_batch_in_flight(trained, monkeypatch):
    """Each batch is dispatched before the previous one is materialized,
    so the host formats one batch while the device computes the next."""
    from kpop_tpu_torch.cli import classify as cli

    events = []
    dispatch, materialize = cli.DeviceStep.dispatch, cli.DeviceStep.materialize

    def logged_dispatch(self, seqs):
        events.append("d")
        return dispatch(self, seqs)

    def logged_materialize(handle):
        events.append("m")
        return materialize(handle)

    monkeypatch.setattr(cli.DeviceStep, "dispatch", logged_dispatch)
    monkeypatch.setattr(cli.DeviceStep, "materialize", staticmethod(logged_materialize))
    monkeypatch.setenv("KPOP_PLATFORM", "cpu")
    monkeypatch.chdir(trained)
    cli.main(["-T", "Classes", "-t", "Classes", "-f", "test_seqs.fasta",
              "--batch", "30", "-o", "InFlight"])
    assert "".join(events) == "ddmdmdmm"  # 100 sequences in batches of 30
    assert len(summaries(trained / "InFlight.KPopSummary.txt")) == 100
