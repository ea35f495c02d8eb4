"""kpop_tpu_torch.ops.encode against kpop_tpu.ops.encode and the host
golden path KmerSpace.window_codes: window codes are compared exactly."""

import numpy as np
import pytest
import torch

from kpop_tpu.core.kmers import PROTEIN_ALPHABET, KmerSpace, encode_dna, encode_protein
from kpop_tpu.ops import encode as jax_encode
from kpop_tpu_torch.ops import encode as torch_encode


def random_seqs(rng, n, length, alphabet="ACGT", breaks="N"):
    letters = list(alphabet) + [breaks]
    p = [0.96 / len(alphabet)] * len(alphabet) + [0.04]
    return [
        "".join(rng.choice(letters, p=p, size=int(rng.integers(length // 2, length))))
        for _ in range(n)
    ]


CASES = [
    ("DNA-ds", 5),
    ("DNA-ss", 5),
    ("DNA-ds", 11),
    ("DNA-ss", 12),
    ("protein", 3),
    ("protein", 5),
]


@pytest.mark.parametrize("content,k", CASES)
def test_window_codes_match_jax_and_host(content, k):
    import jax.numpy as jnp

    rng = np.random.default_rng(k)
    space = KmerSpace(content, k)
    protein = space.base == 20
    seqs = random_seqs(
        rng, 9, 90,
        alphabet=PROTEIN_ALPHABET if protein else "ACGT",
        breaks="*" if protein else "N",
    )
    batch = torch_encode.encode_reads_host(seqs, protein=protein)
    codes, ok = torch_encode.window_codes_batch(
        torch.from_numpy(batch), k, space.canonical, space.base
    )
    codes, ok = codes.numpy(), ok.numpy()
    want_codes, want_ok = jax_encode.window_codes_batch(
        jnp.asarray(batch), k, space.canonical, space.base
    )
    want_ok = np.asarray(want_ok)
    np.testing.assert_array_equal(ok, want_ok)
    np.testing.assert_array_equal(codes[ok], np.asarray(want_codes)[want_ok])
    assert codes.dtype == np.int32
    enc = encode_protein if protein else encode_dna
    for i, s in enumerate(seqs):
        want = space.window_codes(enc(s))
        assert codes[i][ok[i]].tolist() == want.tolist()


def test_window_codes_breaks_invalidate_windows():
    batch = np.array([[0, 1, 2, -1, 3, 0, 1, 2, 3, -1]], dtype=np.int8)
    _, ok = torch_encode.window_codes_batch(torch.from_numpy(batch), 3, True)
    assert ok.numpy()[0].tolist() == [True, False, False, False, True, True, True, False]


def test_window_codes_reject_bad_arguments():
    codes = torch.zeros((1, 4), dtype=torch.int8)
    with pytest.raises(ValueError):
        torch_encode.window_codes_batch(codes, 5, False)
    with pytest.raises(ValueError):
        torch_encode.window_codes_batch(codes, 2, True, base=20)
    with pytest.raises(ValueError):
        torch_encode.window_codes_batch(codes, 16, False)


@pytest.mark.parametrize("base", [4, 20])
def test_k_limits_match_jax(base):
    assert torch_encode.LUT_ENTRIES_MAX == jax_encode.LUT_ENTRIES_MAX
    assert torch_encode.device_k_max(base) == jax_encode.device_k_max(base)
    assert torch_encode.lut_k_max(base) == jax_encode.lut_k_max(base)
    kmax = 30 if base == 4 else 12
    for k in range(1, kmax + 1):
        assert torch_encode.split_k(k, base) == jax_encode.split_k(k, base)


@pytest.mark.parametrize("native_available", [True, False])
@pytest.mark.parametrize("protein", [False, True])
def test_encode_reads_host_matches_jax(monkeypatch, native_available, protein):
    from kpop_tpu import native

    if native_available and not native.available():
        pytest.skip("native library unavailable")
    monkeypatch.setattr(native, "available", lambda: native_available)
    rng = np.random.default_rng(7)
    alphabet = PROTEIN_ALPHABET if protein else "ACGTacgu-"
    seqs = random_seqs(rng, 6, 50, alphabet=alphabet, breaks="X")
    for length in (None, 80):
        got = torch_encode.encode_reads_host(seqs, length, protein)
        want = jax_encode.encode_reads_host(seqs, length, protein)
        assert got.dtype == want.dtype == np.int8
        np.testing.assert_array_equal(got, want)
