"""The 2-bit read wire in kpop_tpu_torch (DNA at 2 bits a base plus a
validity bit a position, as native.pack_2bit_batch writes it) against
kpop_tpu on the CPU, on the same inputs made from a seed with numpy.

Covered: unpack_2bit_batch against the JAX one, pack_reads_2bit (its round
trip, its numpy bytes against the native packer's, its refusal of other
alphabets), spectra_from_codes against the JAX one, count_spectra and
project_reads on packed read sets against the JAX functions on the
unpacked codes (the dense LUT at k = 5; the cuckoo hash and the sorted
limbs at k = 18; f32 and bf16 twisters; a row range), the served step
(DeviceStep) on the k = 18 vocabularies against the JAX functions, its
refusal of any wire but bytes and codes, the checks of the packed inputs,
the row offsets the kernels' row groups take on the wire, the argument
counts of every C entry point of csrc/ against its ctypes binding, and
each layout constant of the count and the bag kernels written once, in
ops/pipeline.py, and compiled into csrc/ as a define.

Tolerances: unpacked codes, counts and indices exactly; projections rtol
1e-5 (f32 sums in another order), with an atol of 1e-5 of the largest |x|
on a bf16 twister (tests/test_torch_bf16.py); distances against JAX rtol
2e-4, atol 1e-5 (the distance tile's bound, tests/test_pallas.py:32: the
two packages' f32 expansions of distances of about 0.1 between rows of
norm 1 differ by up to 2e-5 relative)."""

import functools
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kpop_tpu.core.count import spectrum_of_sequences
from kpop_tpu.core.kmers import KmerSpace, hex_labels_vectorized
from kpop_tpu.core.matrix import KPopMatrix, MatrixType, NamedMatrix
from kpop_tpu.core.twister import Twister
from kpop_tpu.ops import cuckoo as jc
from kpop_tpu.ops import encode as je
from kpop_tpu.ops import pipeline as jp
from kpop_tpu_torch import _build, native
from kpop_tpu_torch.cli.classify import DeviceStep
from kpop_tpu_torch.ops import encode as te
from kpop_tpu_torch.ops import pipeline as tp

from test_torch_large_k import batch_of, seqs_of
from test_torch_pipeline import DIST_ATOL, DIST_RTOL, K, codes_of, served, trained  # noqa: F401

RTOL = 1e-5
BF16_ATOL = 1e-5  # of the largest |x|
CSRC = Path(tp.__file__).resolve().parent.parent / "csrc"


def random_codes(rng, B: int, L: int) -> np.ndarray:
    """[B, L] int8 DNA codes with -1 breaks, a row of no base at all and
    a row of bases only."""
    codes = rng.integers(0, 4, size=(B, L), dtype=np.int8)
    codes[rng.random((B, L)) < 0.15] = -1
    codes[1] = -1
    codes[2] = rng.integers(0, 4, size=L, dtype=np.int8)
    return codes


def packed_of(codes: np.ndarray) -> te.PackedReads:
    packed, valid = te.pack_reads_2bit(codes)
    return te.PackedReads(torch.from_numpy(packed), torch.from_numpy(valid), codes.shape[1])


# ---------------- the wire ------------------------------------------------


@pytest.mark.parametrize("L", list(range(1, 38)) + [63, 64, 65, 127, 128, 129])
def test_unpack_2bit_equal_to_jax(L):
    """Lengths 1 to 37 hold every L % 4 and L % 8 at 4m +- 1 and 8m +- 1;
    row 1 is all -1."""
    codes = random_codes(np.random.default_rng(L), 5, L)
    packed, valid = te.pack_reads_2bit(codes)
    assert packed.shape == (5, te.packed_strides(L)[0]) and valid.shape == (5, te.packed_strides(L)[1])
    want = np.asarray(je.unpack_2bit_batch(jnp.asarray(packed), jnp.asarray(valid), L))
    got = te.unpack_2bit_batch(torch.from_numpy(packed), torch.from_numpy(valid), L)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), codes)
    assert (got[1] == -1).all()


@pytest.mark.parametrize("L", [1, 3, 4, 5, 7, 8, 9, 31, 33, 150])
def test_pack_reads_2bit_round_trip_and_native_bytes(L, monkeypatch):
    """The packer's numpy path writes the native packer's bytes (padding
    bits 0), and the wire unpacks to the codes."""
    codes = random_codes(np.random.default_rng(100 + L), 6, L)
    assert native.available()
    want = native.pack_2bit_batch(codes)
    got = te.pack_reads_2bit(codes)
    monkeypatch.setattr(native, "available", lambda: False)
    plain = te.pack_reads_2bit(codes)
    for g, p, w in zip(got, plain, want):
        assert g.dtype == p.dtype == np.uint8
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(p, w)
    back = te.unpack_2bit_batch(*(torch.from_numpy(a) for a in plain), L)
    np.testing.assert_array_equal(back.numpy(), codes)


def test_pack_reads_2bit_refuses_other_alphabets():
    codes = np.random.default_rng(0).integers(0, 20, size=(3, 40), dtype=np.int8)
    with pytest.raises(ValueError, match="base 20"):
        te.pack_reads_2bit(codes, base=20)


@pytest.mark.parametrize("B,W,n", [(1, 1, 1), (4, 30, 16), (6, 200, 1024)])
def test_spectra_from_codes_equal_to_jax(B, W, n):
    rng = np.random.default_rng(W)
    wcodes = rng.integers(0, n, size=(B, W)).astype(np.int32)
    wcodes[:, : W // 3] = wcodes[:, :1]  # repeats count every time
    valid = rng.random((B, W)) < 0.8
    want = np.asarray(je.spectra_from_codes(jnp.asarray(wcodes), jnp.asarray(valid), n))
    got = te.spectra_from_codes(torch.from_numpy(wcodes), torch.from_numpy(valid), n)
    assert got.shape == (B, n) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------- count and projections on packed read sets ---------------


def lut_case(trained, dtype):  # noqa: F811
    space, twister, coords, _ = trained
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jparams = jp.build_classifier_params(space, twister, coords, dtype=jdt)
    tparams = tp.build_classifier_params(space, twister, coords, device="cpu", dtype=dtype)
    return jparams, tparams, codes_of(trained)


@functools.lru_cache(maxsize=None)
def wide_case(lookup: str, dtype: torch.dtype):
    """DNA-ds k = 18 (two limbs): a twister of d = 6 over the k-mers of half
    of six sequences with N breaks, queries with unknown k-mers, a read of
    one repeated k-mer and one of no valid window; the cuckoo hash or, with
    ``lookup="sorted"``, the sorted limbs in both packages.  Returns both
    packages' parameters, the reads' codes and the reads."""
    k = 18
    rng = np.random.default_rng(18)
    space = KmerSpace("DNA-ds", k)
    seqs = seqs_of("DNA-ds", rng, 6, 150) + ["A" * 100, "N" * 40]
    vocab, _ = spectrum_of_sequences(space, seqs[:3] + seqs[6:7])
    labels = hex_labels_vectorized(np.unique(vocab), space.hex_width)
    labels = [labels[i] for i in rng.permutation(len(labels))]
    d = 6
    dims = ["Dim%d" % (i + 1) for i in range(d)]
    twister = Twister(
        KPopMatrix(MatrixType.TWISTER, NamedMatrix(dims, labels, rng.standard_normal((d, len(labels))))),
        KPopMatrix(MatrixType.INERTIA,
                   NamedMatrix(["inertia"], dims, np.sort(rng.random(d))[::-1][None, :].copy())),
    )
    coords = rng.standard_normal((4, d))
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    with pytest.MonkeyPatch.context() as mp:
        if lookup == "sorted":
            mp.setattr(jc, "build_cuckoo", lambda *a: None)
            mp.setattr(tp, "build_cuckoo", lambda *a: None)
        jparams = jp.build_classifier_params(space, twister, coords, dtype=jdt)
        tparams = tp.build_classifier_params(space, twister, coords, device="cpu", dtype=dtype)
    assert (tparams.cuckoo is None) == (lookup == "sorted")
    return jparams, tparams, batch_of("DNA-ds", seqs), seqs


@pytest.fixture(params=[(lk, dt) for lk in ("lut", "cuckoo", "sorted")
                        for dt in (torch.float32, torch.bfloat16)],
                ids=lambda p: "%s-%s" % (p[0], str(p[1]).split(".")[1]))
def case(request, trained):  # noqa: F811
    lookup, dtype = request.param
    return lut_case(trained, dtype) if lookup == "lut" else wide_case(lookup, dtype)[:3]


def assert_close(got: torch.Tensor, want: np.ndarray, bf16: bool):
    atol = BF16_ATOL * np.abs(want).max() if bf16 else 0.0
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=atol)


def test_packed_count_equal_to_jax(case):
    """The spectra of packed read sets: exactly JAX's count_spectra of the
    unpacked codes, and the int8 codes' spectra."""
    jparams, tparams, codes = case
    reads = packed_of(codes)
    unpacked = je.unpack_2bit_batch(jnp.asarray(reads.packed.numpy()),
                                    jnp.asarray(reads.valid.numpy()), reads.length)
    want = np.asarray(jp.count_spectra(jparams, unpacked))
    got = tp.count_spectra(tparams, reads)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), tp.count_spectra(tparams, torch.from_numpy(codes)).numpy())
    assert want.sum() > 0 and not want[-1].any()  # the last read set has no valid window


@pytest.mark.parametrize("normalize", [True, False])
def test_packed_projections_equal_to_jax(case, normalize):
    """The bag and the dense route on packed read sets against JAX's
    project_reads and project of the unpacked codes."""
    jparams, tparams, codes = case
    reads = packed_of(codes)
    unpacked = je.unpack_2bit_batch(jnp.asarray(reads.packed.numpy()),
                                    jnp.asarray(reads.valid.numpy()), reads.length)
    bf16 = tparams.twister.dtype == torch.bfloat16
    want_bag = np.asarray(jp.project_reads(jparams, unpacked, normalize=normalize, chunk=64))
    want = np.asarray(jp.project(jparams, jp.count_spectra(jparams, unpacked), normalize=normalize))
    got_bag = tp.project_reads(tparams, reads, normalize=normalize)
    got = tp.project(tparams, tp.count_spectra(tparams, reads), normalize=normalize)
    assert_close(got_bag, want_bag, bf16)
    assert_close(got, want, bf16)
    assert torch.equal(got_bag, tp.project_reads(tparams, torch.from_numpy(codes), normalize=normalize))


def test_packed_row_range_equal_to_codes(case):
    """A rank's row range of the count (k-mer-sharded serving) on packed
    read sets: the JAX count's columns, and each read set's known windows."""
    jparams, tparams, codes = case
    reads = packed_of(codes)
    V = tparams.n_vocab
    row0, rows = V // 3, V // 2
    got, known = tp.count_spectra(tparams, reads, row0, rows, known=True)
    want, want_known = tp.count_spectra(tparams, torch.from_numpy(codes), row0, rows, known=True)
    whole = np.asarray(jp.count_spectra(jparams, jnp.asarray(codes)))
    np.testing.assert_array_equal(got.numpy(), whole[:, row0: row0 + rows])
    assert torch.equal(got, want) and torch.equal(known, want_known)
    np.testing.assert_array_equal(known.numpy(), whole.sum(axis=1).astype(np.int32))


# ---------------- the serving step ------------------------------------------


@pytest.mark.parametrize("lookup", ["cuckoo", "sorted"])
@pytest.mark.parametrize("path", ["dense", "bag"])
def test_device_step_wide_matches_jax(path, lookup):
    """The served step, DeviceStep, on wide_case's k = 18 vocabularies,
    from that case's strings: its distances against JAX's
    distances_to_classes of project of count_spectra on the same codes."""
    jparams, tparams, codes, seqs = wide_case(lookup, torch.float32)
    got = served(tparams, path, seqs)
    want = np.asarray(jp.distances_to_classes(
        jparams, jp.project(jparams, jp.count_spectra(jparams, jnp.asarray(codes)))))
    assert got.shape == want.shape == (len(seqs), tparams.class_coords.shape[0])
    np.testing.assert_allclose(got, want, rtol=DIST_RTOL, atol=DIST_ATOL)


def test_device_step_wire_checks(trained):  # noqa: F811
    _, tparams, _ = lut_case(trained, torch.float32)
    for wire in ("utf8", "packed"):  # the 2-bit wire is a kernel input, not a served wire
        with pytest.raises(ValueError, match="'bytes' or 'codes'"):
            DeviceStep(tparams, "dense", wire=wire)


@pytest.mark.parametrize("fault", ["stride", "dtype", "short"])
def test_packed_inputs_checked(trained, fault):  # noqa: F811
    _, tparams, codes = lut_case(trained, torch.float32)
    reads = packed_of(codes)
    if fault == "stride":
        reads = te.PackedReads(reads.packed, reads.valid, reads.length + 8)
    elif fault == "dtype":
        reads = te.PackedReads(reads.packed.to(torch.int8), reads.valid, reads.length)
    else:
        reads = packed_of(codes[:, : K - 1])
    err = ValueError if fault == "short" else TypeError
    for fn in (tp.count_spectra, tp.project_reads):
        with pytest.raises(err):
            fn(tparams, reads)


@pytest.mark.parametrize("b0", [0, 1, 5])
def test_wire_args_step_through_the_packed_strides(b0):
    """A row group from read set b0 starts at row b0 of both byte arrays
    (the strides (L + 3) / 4 and (L + 7) / 8), and of int8 codes at b0 L."""
    codes = random_codes(np.random.default_rng(b0), 7, 29)
    reads = packed_of(codes)
    suffix, ptrs = tp.wire_args(reads, b0)
    assert suffix == "_packed"
    assert ptrs == (reads.packed[b0].data_ptr(), reads.valid[b0].data_ptr())
    t = torch.from_numpy(codes)
    assert tp.wire_args(t, b0) == ("", (t[b0].data_ptr(),))


# ---------------- the C entry points' bindings ---------------------------------


def entry_points() -> dict:
    """Every ``extern "C"`` function of csrc/*.cu -> its argument count."""
    out = {}
    for src in sorted(CSRC.glob("*.cu")):
        text = re.sub(r"//[^\n]*", "", src.read_text())
        for m in re.finditer(r'extern "C"\s+[^(]*?\b(kpop_\w+)\s*\(([^)]*)\)', text):
            out[m.group(1)] = len([a for a in m.group(2).split(",") if a.strip()])
    return out


@pytest.mark.parametrize("name", sorted(_build._SIGNATURES))
def test_binding_matches_its_entry_point(name):
    """ctypes passes what the C function takes: one type an argument, the
    stream last (a pointer argument bound as an int would be cut)."""
    found = entry_points()
    assert name in found, name
    assert len(_build._SIGNATURES[name]) == found[name]
    assert _build._SIGNATURES[name][-1] is _build._P
    assert set(found) - set(_build._SIGNATURES) == {"kpop_error_string"}


# ---------------- the kernels' layout constants ------------------------------

#: ops/pipeline.py's layout constants -> the csrc/ file that lays out its
#: scratch by it, and the kernel's own name for it
LAYOUT = {
    "COUNT_RUN": ("count_spectra.cu", "RUN"),
    "COUNT_SLICE_BYTES": ("count_spectra.cu", "SLICE_BYTES"),
    "COUNT_NARROW_MAX": ("count_spectra.cu", "NARROW_MAX"),
    "COUNT_BUCKET_SLICES": ("count_spectra.cu", "BUCKET_SLICES_MAX"),
    "BAG_COLS": ("embedding_bag.cu", "COLS"),
    "BAG_GROUP": ("embedding_bag.cu", "GROUP"),
    "BAG_TILE_ROWS": ("embedding_bag.cu", "R"),
    "BAG_COUNTERS": ("embedding_bag.cu", "CNT"),
    "BAG_GATHER_TILE_ENTRIES": ("embedding_bag.cu", "GATHER_TILE_ENTRIES"),
}


@pytest.mark.parametrize("name", sorted(LAYOUT))
def test_layout_constant_written_once(name, monkeypatch):
    """The kernels build with ops/pipeline.py's value as -DKPOP_<NAME>;
    the kernel defines its own constant from that define alone, never from
    a literal, and refuses to build without it; another value gives
    another library name, so the kernels rebuild."""
    src, const = LAYOUT[name]
    macro = "KPOP_" + name
    assert set(_build.LAYOUT) == set(LAYOUT)
    assert f"-D{macro}={getattr(tp, name)}" in _build.nvcc_flags()
    text = re.sub(r"//[^\n]*", "", (CSRC / src).read_text())
    defined = re.findall(rf"\bconstexpr\s+\w+\s+{const}\s*=\s*([^;]*);", text)
    assert defined == [macro], f"{src}: {const} = {defined}"
    assert f"!defined({macro})" in text and "#error" in text
    assert not re.search(rf"#\s*define\s+{macro}\b", text)
    before = _build.library_path()
    monkeypatch.setattr(tp, name, getattr(tp, name) * 2)
    assert f"-D{macro}={getattr(tp, name)}" in _build.nvcc_flags()
    assert _build.library_path() != before
