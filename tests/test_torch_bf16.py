"""bf16 twisters in kpop_tpu_torch (``kpop-classify --dtype bf16``) against
the JAX package's bf16 path on the CPU, on the same inputs made from a seed
with numpy.

The JAX package stores the twister in bf16 and sums in f32: the bag widens
each gathered row to f32 (``project_reads``), the dense route casts the f32
spectrum to bf16 and multiplies with an f32 output (``project``), its row
sums taken on the f32 spectrum.  The port does the same; on the CPU its
bag is the plain version and its product the f32 product of the widened
values.

Tolerances: twister bits exactly (both packages round the f32 twister to
bf16); projections within 1e-5 of the largest |x| (f32 sums of the same
bf16 values in another order); CLI summary fields within 1e-5 *
max(1, |x|)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kpop_tpu.core.count import spectrum_of_sequences
from kpop_tpu.core.kmers import KmerSpace, hex_labels_vectorized
from kpop_tpu.core.matrix import KPopMatrix, MatrixType, NamedMatrix
from kpop_tpu.core.twister import Twister
from kpop_tpu.ops import pipeline as jp
from kpop_tpu_torch.ops import pipeline as tp

from test_torch_classify_cli import sh, summaries, trained as quickstart  # noqa: F401
from test_torch_large_k import batch_of, seqs_of
from test_torch_pipeline import codes_of, trained  # noqa: F401

BF16_ATOL = 1e-5  # of the largest |x| of the JAX result
FIELD_BOUND = 1e-5  # CLI summary fields, x max(1, |x|)


def bits(t) -> np.ndarray:
    """The 16 bits of a torch or JAX bf16 array."""
    if isinstance(t, torch.Tensor):
        return t.view(torch.int16).numpy()
    return np.asarray(t).view(np.int16)


def lut_case(trained):  # noqa: F811
    space, twister, coords, _ = trained
    jparams = jp.build_classifier_params(space, twister, coords, dtype=jnp.bfloat16)
    tparams = tp.build_classifier_params(space, twister, coords, device="cpu", dtype=torch.bfloat16)
    return jparams, tparams, codes_of(trained)


def wide_case():
    """k = 16 (two limbs, the cuckoo hash): a twister of d = 9 over the
    k-mers of half of six sequences, queries with unknown k-mers, a read of
    one repeated k-mer and one of no valid window."""
    rng = np.random.default_rng(16)
    space = KmerSpace("DNA-ds", 16)
    seqs = seqs_of("DNA-ds", rng, 6, 150) + ["A" * 100, "N" * 40]
    vocab, _ = spectrum_of_sequences(space, seqs[:3] + seqs[6:7])
    labels = hex_labels_vectorized(np.unique(vocab), space.hex_width)
    labels = [labels[i] for i in rng.permutation(len(labels))]
    d = 9
    dims = ["Dim%d" % (i + 1) for i in range(d)]
    twister = Twister(
        KPopMatrix(MatrixType.TWISTER, NamedMatrix(dims, labels, rng.standard_normal((d, len(labels))))),
        KPopMatrix(MatrixType.INERTIA,
                   NamedMatrix(["inertia"], dims, np.sort(rng.random(d))[::-1][None, :].copy())),
    )
    coords = rng.standard_normal((4, d))
    jparams = jp.build_classifier_params(space, twister, coords, dtype=jnp.bfloat16)
    tparams = tp.build_classifier_params(space, twister, coords, device="cpu", dtype=torch.bfloat16)
    assert tparams.cuckoo is not None
    return jparams, tparams, batch_of("DNA-ds", seqs)


@pytest.fixture(params=["lut", "wide"])
def case(request, trained):  # noqa: F811
    return lut_case(trained) if request.param == "lut" else wide_case()


def test_params_carry_a_bf16_twister_as_jax_does(case):
    """The twister alone is bf16, with JAX's bits; the metric and the class
    tensors stay f32."""
    jparams, tparams, _ = case
    assert tparams.twister.dtype == torch.bfloat16
    np.testing.assert_array_equal(bits(tparams.twister), bits(jparams.twister))
    for name in ("metric", "class_coords", "class_norms"):
        assert getattr(tparams, name).dtype == torch.float32, name
        np.testing.assert_array_equal(getattr(tparams, name).numpy(), np.asarray(getattr(jparams, name)))


def test_params_from_jax_carries_bf16_bits(case):
    jparams, _, codes = case
    arrays = {n: None if getattr(jparams, n) is None else np.asarray(getattr(jparams, n))
              for n in tp.PARAM_ARRAYS}
    assert arrays["twister"].dtype.name == "bfloat16"
    tparams = tp.params_from_jax(arrays, jparams.k, jparams.canonical, jparams.base,
                                 jparams.distance_kind, device="cpu",
                                 cuckoo_seeds=jparams.cuckoo_seeds)
    assert tparams.twister.dtype == torch.bfloat16
    np.testing.assert_array_equal(bits(tparams.twister), bits(jparams.twister))
    np.testing.assert_array_equal(tp.vocab_lookup(tparams, torch.from_numpy(codes)).numpy(),
                                  np.asarray(jp.vocab_lookup(jparams, jnp.asarray(codes))))


@pytest.mark.parametrize("normalize", [True, False])
def test_dense_route_equal_to_jax(case, normalize):
    """count_spectra (f32) then project with the bf16 twister: the spectrum
    cast to bf16, an f32 product, the row sums of the f32 spectrum."""
    jparams, tparams, codes = case
    jspectra = jp.count_spectra(jparams, jnp.asarray(codes))
    want = np.asarray(jp.project(jparams, jspectra, normalize=normalize))
    spectra = tp.count_spectra(tparams, torch.from_numpy(codes))
    assert spectra.dtype == torch.float32
    np.testing.assert_array_equal(spectra.numpy(), np.asarray(jspectra))
    got = tp.project(tparams, spectra, normalize=normalize)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=BF16_ATOL * np.abs(want).max())


@pytest.mark.parametrize("normalize", [True, False])
def test_bag_route_equal_to_jax(case, normalize):
    """project_reads with the bf16 twister: each row widened to f32 and
    summed in f32, on the wrapper (the plain version on the CPU) and the
    plain version at JAX's chunk."""
    jparams, tparams, codes = case
    want = np.asarray(jp.project_reads(jparams, jnp.asarray(codes), normalize=normalize, chunk=64))
    c = torch.from_numpy(codes)
    for got in (tp.project_reads(tparams, c, normalize=normalize),
                tp.project_reads_ref(tparams, c, normalize, chunk=64)):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=BF16_ATOL * np.abs(want).max())


def test_bf16_routes_sum_the_bf16_values(case):
    """Both routes of the port compute the projection of the bf16 values:
    float64 sums of the same widened twister agree with them within f32
    rounding, and differ from the f32 twister's projection by the bf16
    rounding."""
    _, tparams, codes = case
    c = torch.from_numpy(codes)
    counts = tp.count_spectra_ref(tparams, c).double()
    exact = (counts @ tparams.twister.double()) / counts.sum(dim=1).clamp(min=1.0)[:, None]
    scale = float(exact.abs().max())
    for got in (tp.project(tparams, tp.count_spectra(tparams, c)), tp.project_reads(tparams, c)):
        assert float((got.double() - exact).abs().max()) <= 1e-6 * scale


def test_bf16_product_plain_version():
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.integers(0, 400, size=(5, 70)).astype(np.float32)).to(torch.bfloat16)
    b = torch.from_numpy(rng.standard_normal((70, 6)).astype(np.float32)).to(torch.bfloat16)
    got = tp.bf16_product(a, b)
    assert got.dtype == torch.float32
    assert torch.equal(got, a.float() @ b.float())
    want = a.double() @ b.double()
    assert float((got.double() - want).abs().max()) <= 1e-6 * float(want.abs().max())
    with pytest.raises(TypeError):
        tp.bf16_product(a.float(), b)


def test_other_twister_dtypes_still_raise(trained):  # noqa: F811
    space, twister, coords, _ = trained
    with pytest.raises(NotImplementedError):
        tp.build_classifier_params(space, twister, coords, device="cpu", dtype=torch.float16)


@pytest.mark.parametrize("path", ["dense", "bag"])
def test_classify_cli_bf16_equal_to_jax(quickstart, path):  # noqa: F811
    """kpop-classify-torch --dtype bf16 against kpop-classify --dtype bf16
    on the quick start, line by line: the same names and predicted
    classes, 0 misclassified, every number within FIELD_BOUND."""
    args = "-T Classes -t Classes -f test_seqs.fasta --dtype bf16 --project-path %s" % path
    sh("kpop-classify-torch %s -o BT_%s" % (args, path), quickstart)
    sh("kpop-classify %s -o BJ_%s" % (args, path), quickstart)
    got = summaries(quickstart / ("BT_%s.KPopSummary.txt" % path))
    want = summaries(quickstart / ("BJ_%s.KPopSummary.txt" % path))
    assert len(got) == len(want) == 100
    misclassified = 0
    for lg, lw in zip(got, want):
        fg, fw = lg.split("\t"), lw.split("\t")
        assert len(fg) == len(fw) and fg[0] == fw[0]
        assert fg[5] == fw[5], f"{fg[0]}: class {fg[5]} != {fw[5]}"
        misclassified += fg[0].split("-")[1] != fg[5]
        for i, (a, b) in enumerate(zip(fg[1:], fw[1:]), start=1):
            if i % 3 == 2 and i > 4:  # the class names of the top-k groups
                assert a == b
            else:
                assert abs(float(a) - float(b)) <= FIELD_BOUND * max(1.0, abs(float(b))), (fg[0], i)
    assert misclassified == 0
