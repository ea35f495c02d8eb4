"""kpop_tpu_torch.ops.pipeline against kpop_tpu.ops.pipeline on the CPU,
on the same inputs made from a seed with numpy.

The served step, DeviceStep, is held to the JAX classifier on the same
reads.

Tolerances: counts and lookup tables exactly; projections rtol 1e-5 (f32
sums in another order); distances rtol 2e-4, atol 1e-5 (the bound of
tests/test_pallas.py), and so their digests; the digest of the same
distances rtol 1e-5."""

import io
import os

import numpy as np
import pytest
import torch

from kpop_tpu.core.count import spectrum_of_sequences
from kpop_tpu.core.counter_db import CounterDB
from kpop_tpu.core.kmers import KmerSpace
from kpop_tpu.core.space import Distance
from kpop_tpu.core.twister import twist_counter_db
from kpop_tpu.ops import pipeline as jp
from kpop_tpu.ops.encode import encode_reads_host
from kpop_tpu_torch.cli.classify import DeviceStep
from kpop_tpu_torch.config import device
from kpop_tpu_torch.ops import pipeline as tp

K = 5
N_CLASSES = 6
# distances of two f32 expansions (JAX's and the port's): the bound of
# tests/test_pallas.py:32
DIST_RTOL, DIST_ATOL = 2e-4, 1e-5
FIELDS = ("vocab_lut", "twister", "metric", "class_coords", "class_norms")


def mutate(rng, g, n):
    g = g.copy()
    pos = rng.choice(len(g), size=n, replace=False)
    g[pos] = (g[pos] + rng.integers(1, 4, size=n)) % 4
    return g


def to_str(g):
    return "".join("ACGT"[b] for b in g)


@pytest.fixture(scope="module")
def trained():
    """A twister trained on 6 classes of mutated 300-base genomes, and
    queries: mutated members of each class, one with an N break, one
    repeating a k-mer many times, and one with no known k-mer."""
    rng = np.random.default_rng(11)
    space = KmerSpace("DNA-ds", K)
    roots = [rng.integers(0, 4, size=300) for _ in range(N_CLASSES)]
    db = CounterDB()
    for c, g in enumerate(roots):
        seqs = [to_str(mutate(rng, g, 10)) for _ in range(3)]
        codes, counts = spectrum_of_sequences(space, seqs)
        buf = "\tC%d\n" % c + "".join(
            "%s\t%d\n" % (space.code_to_hex(cd), ct) for cd, ct in zip(codes, counts)
        )
        db.add_spectra_stream(io.StringIO(buf))
    twister, twisted, _ = twist_counter_db(db)
    queries = [to_str(mutate(rng, roots[i % N_CLASSES], 12)) for i in range(10)]
    queries[1] = queries[1][:100] + "NNN" + queries[1][100:]
    queries.append("ACGTA" * 30)  # one k-mer repeated: duplicates must count
    queries.append("NNNNNNNNNNNN")  # no valid window
    return space, twister, np.asarray(twisted.matrix.data), queries


def both_params(trained, distance="euclidean"):
    space, twister, coords, _ = trained
    dist = Distance.of_string(distance)
    jparams = jp.build_classifier_params(space, twister, coords, distance=dist)
    tparams = tp.build_classifier_params(
        space, twister, coords, distance=dist, device="cpu"
    )
    return jparams, tparams


def codes_of(trained):
    return encode_reads_host(trained[3])


def served(tparams, path: str, seqs) -> np.ndarray:
    """The [B, C] f32 distances of ``seqs`` through the step the server and
    the benchmark run, ``DeviceStep(tparams, path)``: on the CPU, on the
    codes wire."""
    step = DeviceStep(tparams, path)
    assert step.wire == "codes"
    return step.materialize(step.dispatch(list(seqs))).astype(np.float32)


def test_build_classifier_params_equal_to_jax(trained):
    jparams, tparams = both_params(trained)
    for name in FIELDS:
        want = np.asarray(getattr(jparams, name))
        got = getattr(tparams, name).numpy()
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert (tparams.k, tparams.canonical, tparams.base, tparams.distance_kind) == (
        jparams.k, jparams.canonical, jparams.base, jparams.distance_kind,
    )
    assert tparams.n_vocab == jparams.n_vocab


def test_params_are_contiguous_for_fortran_order_inputs(trained):
    """The kernels take contiguous tensors; CA coordinates come out of
    numpy in Fortran order."""
    space, twister, coords, _ = trained
    params = tp.build_classifier_params(
        space, twister, np.asfortranarray(coords), device="cpu"
    )
    for name, buf in params.named_buffers():
        assert buf.is_contiguous(), name


def test_params_from_jax_round_trip(trained):
    jparams, _ = both_params(trained, "cosine")
    arrays = {name: np.asarray(getattr(jparams, name)) for name in FIELDS}
    tparams = tp.params_from_jax(
        arrays, jparams.k, jparams.canonical, jparams.base,
        jparams.distance_kind, device="cpu",
    )
    assert tparams.distance_kind == "cosine"
    buffers = dict(tparams.named_buffers())
    assert set(buffers) == set(FIELDS)
    for name in FIELDS:
        np.testing.assert_array_equal(buffers[name].numpy(), arrays[name])


def test_count_spectra_exact(trained):
    import jax.numpy as jnp

    jparams, tparams = both_params(trained)
    codes = codes_of(trained)
    want = np.asarray(jp.count_spectra(jparams, jnp.asarray(codes)))
    got = tp.count_spectra(tparams, torch.from_numpy(codes)).numpy()
    assert got.shape == want.shape == (len(codes), jparams.n_vocab)
    np.testing.assert_array_equal(got, want)
    # the repeated k-mer counts every time it occurs
    assert got[-2].max() >= 25
    assert got[-1].sum() == 0
    ref = tp.count_spectra_ref(tparams, torch.from_numpy(codes)).numpy()
    np.testing.assert_array_equal(ref, want)


def test_vocab_lookup_equal_to_jax(trained):
    import jax.numpy as jnp

    jparams, tparams = both_params(trained)
    codes = codes_of(trained)
    want = np.asarray(jp.vocab_lookup(jparams, jnp.asarray(codes)))
    got = tp.vocab_lookup(tparams, torch.from_numpy(codes)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("normalize", [True, False])
def test_project_and_project_reads(trained, normalize):
    import jax.numpy as jnp

    jparams, tparams = both_params(trained)
    codes = codes_of(trained)
    spectra = jp.count_spectra(jparams, jnp.asarray(codes))
    want = np.asarray(jp.project(jparams, spectra, normalize=normalize))
    got = tp.project(
        tparams, torch.from_numpy(np.array(spectra)), normalize=normalize
    ).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    want_bag = np.asarray(
        jp.project_reads(jparams, jnp.asarray(codes), normalize=normalize, chunk=64)
    )
    got_bag = tp.project_reads(
        tparams, torch.from_numpy(codes), normalize=normalize
    ).numpy()
    np.testing.assert_allclose(got_bag, want_bag, rtol=1e-5, atol=1e-7)
    got_ref = tp.project_reads_ref(
        tparams, torch.from_numpy(codes), normalize=normalize, chunk=64
    ).numpy()
    np.testing.assert_allclose(got_ref, want_bag, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("distance", ["euclidean", "cosine"])
def test_distances_to_classes(trained, distance, normalize):
    import jax.numpy as jnp

    jparams, tparams = both_params(trained, distance)
    twisted = np.random.default_rng(3).standard_normal(
        (9, tparams.twister.shape[1])
    ).astype(np.float32)
    want = np.asarray(
        jp.distances_to_classes(jparams, jnp.asarray(twisted), normalize=normalize)
    )
    got = tp.distances_to_classes(
        tparams, torch.from_numpy(twisted), normalize=normalize
    ).numpy()
    assert got.shape == (9, N_CLASSES)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-5)


@pytest.mark.parametrize("C", [9, 10])
def test_summarize_batch(C):
    import jax.numpy as jnp

    dmat = np.random.default_rng(C).random((7, C)).astype(np.float32)
    want = [np.asarray(x) for x in jp.summarize_batch(jnp.asarray(dmat), 3)]
    got = [x.numpy() for x in tp.summarize_batch(torch.from_numpy(dmat), 3)]
    for g, w, name in zip(got[:5], want[:5], ("mean", "std", "median", "mad", "top")):
        np.testing.assert_allclose(g, w, rtol=1e-5, err_msg=name)
    np.testing.assert_array_equal(got[5], want[5])
    srt = np.sort(dmat, axis=1)
    np.testing.assert_array_equal(got[2], srt[:, C // 2])  # upper median


@pytest.mark.parametrize("C", [5, 64, 2048])
def test_summarize_batch_ties_in_index_order_as_jax(C):
    """Integer-valued rows tie often: the nearest classes come lowest index
    first, as lax.top_k(-dmat) returns them, so the indices equal JAX's."""
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    dmat = rng.integers(0, max(2, C // 4), size=(64, C)).astype(np.float32)
    want = [np.asarray(x) for x in jp.summarize_batch(jnp.asarray(dmat), 2)]
    got = [x.numpy() for x in tp.summarize_batch(torch.from_numpy(dmat), 2)]
    np.testing.assert_array_equal(got[5], want[5])
    for g, w, name in zip(got[:5], want[:5], ("mean", "std", "median", "mad", "top")):
        np.testing.assert_allclose(g, w, rtol=1e-5, err_msg=name)
    assert (np.diff(np.sort(dmat, axis=1)[:, :2], axis=1) == 0).any()  # the rows do tie


def test_summarize_batch_upper_median():
    dmat = torch.tensor([[1.0, 2.0, 3.0, 4.0]])
    _, _, median, mad, _, _ = tp.summarize_batch(dmat)
    assert median.item() == 3.0  # torch.median would give 2.0
    assert mad.item() == 1.0  # |d - 3| = [2, 1, 0, 1], sorted [0, 1, 1, 2]


@pytest.mark.parametrize("req_len", [1, 2, 3])
@pytest.mark.parametrize("path", ["dense", "bag"])
def test_device_step_matches_jax(trained, path, req_len):
    """The served step, DeviceStep, on the LUT: its distances against the
    JAX TpuClassifier's, and their digest against JAX's classify_step."""
    import jax.numpy as jnp

    jparams, tparams = both_params(trained)
    seqs = trained[3][:-2]  # the last two tie on every class
    codes = encode_reads_host(seqs)
    got = served(tparams, path, seqs)
    want = jp.TpuClassifier(jparams, req_len=req_len).classify_codes(codes)
    assert got.shape == (len(seqs), N_CLASSES)
    np.testing.assert_allclose(got, want[7], rtol=DIST_RTOL, atol=DIST_ATOL)
    digest = [t.numpy() for t in tp.summarize_batch(torch.from_numpy(got), req_len)]
    step = jp.classify_step(*[getattr(jparams, n) for n in FIELDS], jnp.asarray(codes),
                            k=K, canonical=True, req_len=req_len)
    np.testing.assert_array_equal(digest[5], np.asarray(step[5]))  # predicted classes
    assert (digest[5][:, 0] == np.arange(len(seqs)) % N_CLASSES).all()
    for g, w, name in zip(digest[:5], step[:5], ("mean", "std", "median", "mad", "top")):
        np.testing.assert_allclose(g, np.asarray(w), rtol=DIST_RTOL, atol=DIST_ATOL,
                                   err_msg=name)


def test_import_pins_full_f32_precision():
    import kpop_tpu_torch  # noqa: F401

    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


def test_unported_paths_raise(trained):
    space, twister, coords, _ = trained
    jparams, tparams = both_params(trained)
    arrays = {name: np.asarray(getattr(jparams, name)) for name in FIELDS}
    arrays["twister"] = arrays["twister"].astype(np.float16)
    with pytest.raises(NotImplementedError):
        tp.params_from_jax(arrays, K, True, 4, "euclidean", device="cpu")
    with pytest.raises(NotImplementedError):
        tp.ClassifierParams(
            tparams.vocab_lut, tparams.twister.to(torch.float16), tparams.metric,
            tparams.class_coords, tparams.class_norms, K, True,
        )
    # bf16 twisters are served (tests/test_torch_bf16.py)
    bf16 = tp.ClassifierParams(
        tparams.vocab_lut, tparams.twister.to(torch.bfloat16), tparams.metric,
        tparams.class_coords, tparams.class_norms, K, True,
    )
    assert bf16.twister.dtype == torch.bfloat16 and bf16.metric.dtype == torch.float32
    # k above the dense-LUT limit builds the cuckoo lookup; above two limbs
    # split_k raises
    wide = tp.build_classifier_params(KmerSpace("DNA-ds", 13), twister, coords, device="cpu")
    assert wide.vocab_lut is None and wide.cuckoo is not None and len(wide.cuckoo_seeds) == 4
    with pytest.raises(ValueError, match="two-limb"):
        tp.ClassifierParams(
            None, tparams.twister, tparams.metric, tparams.class_coords,
            tparams.class_norms, 31, True, cuckoo=wide.cuckoo, cuckoo_seeds=wide.cuckoo_seeds,
        )
    with pytest.raises(TypeError):
        tp.count_spectra(tparams, torch.zeros((2, 10), dtype=torch.int32))
    with pytest.raises(ValueError):
        tp.project_reads(tparams, torch.zeros((2, K - 1), dtype=torch.int8))


def test_device_selection(monkeypatch):
    monkeypatch.setenv("KPOP_PLATFORM", "cpu")
    assert device() == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for value in ("cuda", "gpu"):
        monkeypatch.setenv("KPOP_PLATFORM", value)
        with pytest.raises(RuntimeError):
            device()
    monkeypatch.delenv("KPOP_PLATFORM")
    with pytest.raises(RuntimeError):
        device()
    monkeypatch.setenv("KPOP_PLATFORM", "tpu")
    with pytest.raises(ValueError):
        device()
    assert os.environ["KPOP_PLATFORM"] == "tpu"
