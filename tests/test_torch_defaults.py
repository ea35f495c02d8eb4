"""The port's entry points run on the card unless asked for the CPU.

- kpop-twist-torch, kpop-twistdb-torch -s and kpop-countdb-torch
  --distances with no --backend reach their device functions
  (ca_fit_sharded, summarize_rowwise_device, distance_rowwise_device):
  spied on under KPOP_PLATFORM=cpu, outputs not compared here (the CLI
  tests do that);
- with KPOP_PLATFORM unset and no card they raise config.device()'s
  RuntimeError, while --backend host runs;
- ca_fit_sharded(phi="host") streams phi to the host block by block, so a
  budget between its footprint and that of a twister kept on the device
  in float64 trains, bit-identical to the fit without a budget; the JAX
  package stays resident (unstreamed) at the same budget."""

import io

import numpy as np
import pytest
import torch

from kpop_tpu_torch.cli import countdb, twist, twistdb
from kpop_tpu_torch.core.count import spectrum_of_sequences
from kpop_tpu_torch.core.counter_db import CounterDB
from kpop_tpu_torch.core.kmers import KmerSpace
from kpop_tpu_torch.core.twister import twist_counter_db
from kpop_tpu_torch.ops import summaries
from kpop_tpu_torch.parallel import sharded


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A 5-spectrum counts DB and its host-trained twister."""
    td = tmp_path_factory.mktemp("defaults_torch")
    rng = np.random.default_rng(5)
    space = KmerSpace("DNA-ds", 4)
    db = CounterDB()
    for c in range(5):
        seq = "".join(np.array(list("ACGT"))[rng.integers(0, 4, 200)])
        codes, counts = spectrum_of_sequences(space, [seq])
        db.add_spectra_stream(io.StringIO("\tS%d\n" % c + "".join(
            "%s\t%d\n" % (space.code_to_hex(cd), ct) for cd, ct in zip(codes, counts))))
    db.to_binary(str(td / "DB"))
    twister, twisted, _ = twist_counter_db(db, backend="host")
    twister.to_binary(str(td / "TW"))
    twisted.to_binary(str(td / "TW"))
    return td


def argv(tool: str, td, backend: list[str]) -> list[str]:
    out = str(td / f"out_{tool}_{'_'.join(backend) or 'default'}")
    if tool == "twist":
        return [*backend, "-i", str(td / "DB"), "-o", out]
    if tool == "twistdb":
        tw = str(td / "TW")
        return ["-i", "T", tw, "-i", "t", tw, *backend, "-s", tw, out]
    return ["-i", str(td / "DB"), *backend, "--distances", "~.", "~.", out]


MAINS = {"twist": twist.main, "twistdb": twistdb.main, "countdb": countdb.main}
DEVICE_FUNCTIONS = {
    "twist": (sharded, "ca_fit_sharded"),
    "twistdb": (summaries, "summarize_rowwise_device"),
    "countdb": (summaries, "distance_rowwise_device"),
}


@pytest.mark.parametrize("tool", sorted(MAINS))
def test_default_backend_reaches_the_device_function(files, tool, monkeypatch):
    monkeypatch.setenv("KPOP_PLATFORM", "cpu")
    module, name = DEVICE_FUNCTIONS[tool]
    real, calls = getattr(module, name), []

    def spy(*args, **kwargs):
        calls.append(kwargs.get("backend"))
        return real(*args, **kwargs)

    monkeypatch.setattr(module, name, spy)
    assert MAINS[tool](argv(tool, files, [])) == 0
    assert calls, f"{tool}: {name} was not called"
    if tool != "twist":
        assert calls == ["pallas"]


@pytest.mark.parametrize("tool", sorted(MAINS))
def test_default_backend_without_a_card_raises(files, tool, monkeypatch):
    monkeypatch.delenv("KPOP_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MAINS[tool](argv(tool, files, []))


@pytest.mark.parametrize("tool", sorted(MAINS))
def test_host_backend_runs_without_a_card(files, tool, monkeypatch):
    monkeypatch.delenv("KPOP_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    module, name = DEVICE_FUNCTIONS[tool]
    monkeypatch.setattr(module, name, lambda *a, **k: pytest.fail(f"{name} was called"))
    assert MAINS[tool](argv(tool, files, ["--backend", "host"])) == 0


def budget_case():
    """A u8 table of 600 k-mers x 12 samples (d = 11), phi blocks of 64
    rows, and a budget between the streamed and the resident footprints."""
    table = np.random.default_rng(6).integers(0, 50, size=(600, 12)).astype(np.int32)
    nk, ns = table.shape
    d = ns - 1
    block_bytes = 64 * ns * 8
    streamed = nk * ns + 64 * (2 * ns + 2 * d) * 8
    resident_f64 = nk * (ns + 8 * d)
    budget = nk * (ns + 6 * d)  # JAX's footprint nk (ns + 4 d) fits
    assert streamed < nk * (ns + 4 * d) < budget < resident_f64
    return table, block_bytes, budget, streamed


def test_host_phi_trains_between_the_footprints():
    table, block_bytes, budget, _ = budget_case()
    got = sharded.ca_fit_sharded(table, hbm_bytes=budget, block_bytes=block_bytes, device="cpu")
    want = sharded.ca_fit_sharded(table, hbm_bytes=0, block_bytes=block_bytes, device="cpu")
    assert sharded.LAST_DD_UPLOAD == "u8"
    assert got[2].shape == (table.shape[1] - 1, table.shape[0])
    for a, b in zip(got, want):
        assert np.array_equal(a, b)


def test_host_phi_budget_counts_one_block():
    """One byte below the wire table plus two blocks of S's size and two
    phi blocks, the fit streams and gives the same fit within 1e-10; at it,
    it stays resident."""
    table, block_bytes, _, streamed = budget_case()
    got = sharded.ca_fit_sharded(table, hbm_bytes=streamed - 1, block_bytes=block_bytes,
                                 device="cpu")
    assert sharded.LAST_CA_STREAM is not None and sharded.LAST_CA_STREAM["n_blocks"] > 1
    want = sharded.ca_fit_sharded(table, hbm_bytes=streamed, block_bytes=block_bytes, device="cpu")
    assert sharded.LAST_CA_STREAM is None
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-10 * float(np.abs(b).max()))


def test_jax_stays_resident_at_the_same_budget():
    from kpop_tpu.parallel import sharded as jax_sharded
    from kpop_tpu.parallel.mesh import make_mesh

    table, block_bytes, budget, _ = budget_case()
    want = sharded.ca_fit_sharded(table, hbm_bytes=budget, block_bytes=block_bytes, device="cpu")
    ref = jax_sharded.ca_fit_sharded(make_mesh(1), table, hbm_bytes=budget)
    assert jax_sharded.LAST_CA_STREAM is None
    np.testing.assert_allclose(np.abs(ref[3]), np.abs(want[3]), rtol=0, atol=1e-8)
