"""The fused serving pipeline: the counterpart of
``kpop_tpu/ops/pipeline.py``.

    base codes -> window codes -> vocabulary LUT -> [B, V] spectrum
      -> [B, V] x [V, d] twister product -> distances to the C classes
      -> mean, std, upper median, MAD and top-k

or, in place of the spectrum and the product, the embedding bag
(:func:`project_reads`).  The public functions keep the JAX package's names
and layouts: ``[B, L]`` int8 base codes, a ``[V, d]`` twister, ``[B, C]``
distances.

Three steps are CUDA kernels on a card: counting (``csrc/count_spectra.cu``:
each window looked up once, then the spectrum counted in shared memory and
written once, slice by slice), the embedding bag
(``csrc/embedding_bag.cu``) and the euclidean distance tile
(``csrc/pairwise.cu`` through :mod:`.pairwise`).  Each wrapper runs its
plain PyTorch version (``*_ref``) for tensors on the CPU and launches its
kernel, or raises, for tensors on a card.  The twister product is a plain
``torch.matmul``, as the JAX package left it to XLA.

The twister is f32 or, as ``kpop-classify --dtype bf16`` builds it, bf16:
half the bytes of the one large tensor.  Every sum stays f32, as in the
JAX package: the bag widens each row to f32 in the kernel, and the dense
route casts the f32 spectrum to bf16 and multiplies with an f32 output
(``torch.mm(..., out_dtype=torch.float32)``), its row sums taken on the
f32 spectrum.

Up to k = :func:`~.encode.lut_k_max` a window code is looked up in a dense
table; above it (DNA k up to 30, protein up to 12) its two int32 limbs are
looked up in a cuckoo hash or, when the hash could not be built, by binary
search in the sorted limbs.  The count and the bag each have a second C
entry point for that lookup (``kpop_count_spectra_wide``,
``kpop_embedding_bag_wide``; ``csrc/wide_lookup.cuh``).  DNA read sets
may come on the 2-bit wire (:class:`~.encode.PackedReads`, 3/8 of a byte
a base): each of the four entry points has a ``_packed`` twin that reads
it as it is, with the same result (:func:`classify_step_packed`).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from ..core.kmers import KmerSpace
from ..core.space import Distance, Metric, normalizations
from ..core.twister import Twister

from .. import _build
from .cuckoo import build_cuckoo, cuckoo_lookup_ref, probe_table
from .encode import (
    PackedReads,
    as_codes,
    check_row_length,
    lut_k_max,
    packed_strides,
    searchsorted_2limb,
    split_k,
    window_codes_batch,
    window_codes_batch_wide,
)
from .pairwise import H100_SMS, _sm_count, distance_tile, row_norms

#: twister dtypes, with the bag kernel's code for each row type
BAG_ROW_TYPES = {torch.float32: 0, torch.bfloat16: 1}
#: elements to which the rows of a bf16 twister are aligned (16 bytes), so
#: that the bag kernel reads each row by aligned 8-byte words
BF16_ROW_ALIGN = 8

#: twister columns per accumulate block of the embedding-bag kernel
#: (csrc/embedding_bag.cu), 4 a lane
BAG_COLS = 128
#: read sets per pass of the bag kernel: 8 bits of its keys
BAG_GROUP = 128
#: vocabulary rows per tile of the bag kernel: its R, a hit mask of 4
#: words
BAG_TILE_ROWS = 128
#: counters of the bag kernel's key list a tile: 8 buckets of 16 rows, 4
#: counters a bucket
BAG_COUNTERS = 32
#: the bag kernel's gather regime: a pass whose vocabulary tiles that hold
#: keys hold at most this many (row, read set) entries on average reads
#: each entry's row straight into registers (``bag_gather``), else through
#: a ring in shared memory (``bag_accumulate``); the two give the same bits
BAG_GATHER_TILE_ENTRIES = 300
#: windows a thread of the count kernel (csrc/count_spectra.cu) looks up
#: and merges; the index scratch pads each read set to a multiple of it
COUNT_RUN = 8
#: shared-memory bytes of counters a block of the count kernel holds: one
#: slice of the vocabulary
COUNT_SLICE_BYTES = 96 * 1024
#: most windows a read set for the count kernel's u16 counters
COUNT_NARROW_MAX = 65535
#: most slices of the count's bucketed plan: its scatter's bins in shared
#: memory
COUNT_BUCKET_SLICES = 8192
#: most read sets a count launch takes: its lookup's grid.y
COUNT_MAX_ROWS = 65535
_INT_MAX = 2**31 - 1
#: most windows a read set on the bag route: a launch's keys and entries
#: are int32, 2 W of them for one read set
BAG_MAX_WINDOWS = _INT_MAX // 2


class ClassifierParams(nn.Module):
    """Device-resident parameters of the count + twist + classify model.

    Buffers: ``twister [V, d]`` f32, or bf16 in rows at a stride aligned to
    16 bytes (a bf16 twister given in other rows is laid out so, by
    :func:`bf16_rows`: the bag kernel reads its rows by aligned words),
    ``metric [d]``,
    ``class_coords [C, d]``, ``class_norms [C]`` (f32) and the vocabulary.  Up to k =
    :func:`~.encode.lut_k_max` the vocabulary is ``vocab_lut [base^k + 1]``
    int32 (code -> twister row, V for a k-mer outside the vocabulary).
    Above it (DNA k up to 30, protein up to 12) ``vocab_lut`` is None, the
    twister rows are in the order of the sorted k-mer codes, and a window
    code's two int32 limbs (:func:`~.encode.window_codes_batch_wide`) are
    looked up in ``cuckoo [6, S]`` int32 with its four ``cuckoo_seeds``
    (:mod:`.cuckoo`) or, when the cuckoo build failed, by binary search in
    the sorted limbs ``vocab_hi``/``vocab_lo [V]`` int32.  The kernels read
    the cuckoo table in the layout of :func:`~.cuckoo.probe_table`, built
    here once on the table's device: ``cuckoo_probe [9 S]`` int32 (36
    bytes a slot of each table, 75.5 MB at S = 2^21), an attribute and not a
    buffer, since the JAX package's parameters have no such array; the
    sorted limbs likewise as ``vocab_limbs [V, 2]`` {hi, lo}.

    A rank of k-mer-sharded serving (:mod:`..parallel.serving`) holds only
    the twister rows ``[row0, row0 + twister.shape[0])`` of a vocabulary of
    ``vocab_size`` rows, with the whole vocabulary's tables; ``n_vocab`` is
    then ``vocab_size``, the index of a miss.
    """

    def __init__(
        self,
        vocab_lut: torch.Tensor | None,
        twister: torch.Tensor,
        metric: torch.Tensor,
        class_coords: torch.Tensor,
        class_norms: torch.Tensor,
        k: int,
        canonical: bool,
        base: int = 4,
        distance_kind: str = "euclidean",
        vocab_hi: torch.Tensor | None = None,
        vocab_lo: torch.Tensor | None = None,
        cuckoo: torch.Tensor | None = None,
        cuckoo_seeds: tuple = (),
        vocab_size: int | None = None,
        row0: int = 0,
    ):
        super().__init__()
        if twister.dtype not in BAG_ROW_TYPES:
            raise NotImplementedError(
                f"{twister.dtype} twisters: the port serves f32 and bf16 ones, "
                "as the JAX package's kpop-classify --dtype does"
            )
        if distance_kind not in ("euclidean", "cosine"):
            raise ValueError(
                f"device classification supports euclidean/cosine, "
                f"not {distance_kind!r}"
            )
        V = twister.shape[0] if vocab_size is None else int(vocab_size)
        if k <= lut_k_max(base):
            if vocab_lut is None or vocab_lut.shape != (base**k + 1,) or vocab_lut.dtype != torch.int32:
                raise ValueError(
                    f"k={k}: vocab_lut must be int32 of shape ({base**k + 1},), got "
                    f"{None if vocab_lut is None else (vocab_lut.dtype, tuple(vocab_lut.shape))}"
                )
        else:
            split_k(k, base)  # raises above two limbs
            if vocab_lut is not None:
                raise ValueError(f"k={k} is above the dense-LUT limit {lut_k_max(base)}")
            if cuckoo is not None:
                S = cuckoo.shape[-1]
                if cuckoo.dtype != torch.int32 or cuckoo.shape != (6, S) or S & (S - 1) \
                        or len(cuckoo_seeds) != 4:
                    raise ValueError("cuckoo must be int32 [6, 2^n] with 4 seeds")
            elif not all(t is not None and t.dtype == torch.int32 and t.shape == (V,)
                         for t in (vocab_hi, vocab_lo)):
                raise ValueError(f"k={k}: a cuckoo table or int32 [{V}] vocab_hi/vocab_lo")
        if twister.dtype == torch.bfloat16 and not bf16_aligned(twister):
            twister = bf16_rows(twister)
        self.register_buffer("vocab_lut", vocab_lut)
        self.register_buffer("twister", twister)
        self.register_buffer("metric", metric)
        self.register_buffer("class_coords", class_coords)
        self.register_buffer("class_norms", class_norms)
        self.register_buffer("vocab_hi", vocab_hi)
        self.register_buffer("vocab_lo", vocab_lo)
        self.register_buffer("cuckoo", cuckoo)
        self.cuckoo_seeds = tuple(int(s) for s in cuckoo_seeds)
        self.cuckoo_probe = None if cuckoo is None else probe_table(cuckoo, self.cuckoo_seeds)
        self.vocab_limbs = None if vocab_hi is None else torch.stack([vocab_hi, vocab_lo], 1)
        self.k = k
        self.canonical = canonical
        self.base = base
        self.distance_kind = distance_kind
        self.vocab_size = V
        self.row0 = int(row0)

    @property
    def n_vocab(self) -> int:
        """Rows of the whole vocabulary: the twister's, unless it holds a
        range of them."""
        return self.vocab_size


#: the arrays of the JAX package's ClassifierParams that the port carries
PARAM_ARRAYS = (
    "vocab_lut", "twister", "metric", "class_coords", "class_norms",
    "vocab_hi", "vocab_lo", "cuckoo",
)


def build_classifier_params(
    space: KmerSpace,
    twister: Twister,
    class_coords: np.ndarray,
    distance: Distance | None = None,
    metric: Metric | None = None,
    device: torch.device | str | None = None,
    dtype: torch.dtype = torch.float32,
) -> ClassifierParams:
    """Assemble device parameters from host artefacts, as the JAX
    ``build_classifier_params`` does: the host ``[d, V]`` twister, as
    ``[V, d]`` f32, has its rows put in order and is cast to ``dtype`` on
    the host, and only then uploaded, so the device never holds more than
    the twister it serves (see :func:`params_around_twister`)."""
    from ..config import device as default_device

    device = default_device() if device is None else torch.device(device)
    tw = np.asarray(twister.twister.matrix.data, dtype=np.float32).T  # [V, d]
    return _params(
        space, twister.kmer_names, torch.from_numpy(np.ascontiguousarray(tw)),
        np.asarray(twister.inertia.matrix.data[0]), class_coords, distance, metric, dtype, device,
    )


def params_around_twister(
    space: KmerSpace,
    kmer_names: list[str],
    twister: torch.Tensor,
    inertia: np.ndarray,
    class_coords: np.ndarray,
    distance: Distance | None = None,
    metric: Metric | None = None,
    dtype: torch.dtype = torch.float32,
) -> ClassifierParams:
    """Classifier parameters around a ``[V, d]`` f32 twister that already
    lies on its device, such as the one ``ca_fit_sharded(phi="device")``
    trains (the train-to-serve handoff of ``bench.py``, without a download).
    ``dtype`` (f32 or bf16) applies to the twister alone, cast on its
    device after the rows are put in order; the metric and the class
    tensors stay f32, as in the JAX package.
    Unknown k-mers are routed to V (dropped, lib/Twister.ml:167-169); the
    metric comes from the inertia (lib/Twister.ml:208-209).

    Up to k = :func:`~.encode.lut_k_max` the hex k-mer labels become a
    lookup table over the whole base^k code space.  Above it, as in the
    JAX package: the codes are sorted (a stable argsort), split into limbs
    at ``base**k_lo``, and hashed by :func:`~.cuckoo.build_cuckoo` (or kept
    as sorted limbs when no seed converges); the twister's rows are
    gathered into the sorted order, which briefly holds a second copy of
    the twister on its device."""
    return _params(space, kmer_names, twister, inertia, class_coords, distance, metric, dtype,
                   twister.device)


def _params(space, kmer_names, twister, inertia, class_coords, distance, metric, dtype,
            device) -> ClassifierParams:
    """:func:`params_around_twister` on ``device``: the twister's rows put
    in order and cast to ``dtype`` where the twister lies, then moved to
    ``device``."""
    if dtype not in BAG_ROW_TYPES:
        raise NotImplementedError(f"{dtype} twisters: f32 or bf16")
    vocab, order = serving_vocab(space, kmer_names)
    if order is not None:
        twister = twister.index_select(0, torch.as_tensor(order, device=twister.device))
    if dtype == torch.bfloat16:
        twister = bf16_rows(twister, device)
    else:
        twister = twister.to(dtype=dtype).to(device)
    return assemble_params(space, vocab, twister, inertia, class_coords, distance, metric, device)


def serving_vocab(space: KmerSpace, kmer_names: list[str]) -> tuple[dict, np.ndarray | None]:
    """The vocabulary of the hex k-mer labels as host arrays: ``vocab_lut``
    up to k = :func:`~.encode.lut_k_max` (the twister's rows in the labels'
    order: returns None for the order), else :func:`wide_vocab`'s tables
    and the order the twister's rows take."""
    kmer_codes = np.array([space.hex_to_code(h) for h in kmer_names], dtype=np.uint64)
    V = len(kmer_codes)
    if space.k <= lut_k_max(space.base):
        lut = np.full(space.n_kmers + 1, V, dtype=np.int32)
        lut[kmer_codes.astype(np.int64)] = np.arange(V, dtype=np.int32)
        return dict(vocab_lut=lut), None
    return wide_vocab(space, kmer_codes)


def assemble_params(space: KmerSpace, vocab: dict, twister: torch.Tensor, inertia, class_coords,
                    distance: Distance | None = None, metric: Metric | None = None,
                    device=None, **extra) -> ClassifierParams:
    """:class:`ClassifierParams` of a twister already in its rows' order,
    dtype and device, with the host ``vocab`` of :func:`serving_vocab`
    moved to ``device``: the metric from the inertia (lib/Twister.ml:
    208-209) and the class norms.  ``extra`` goes to the constructor."""
    distance = distance or Distance.of_string("euclidean")
    metric = metric or Metric.of_string("powers(1,1,2)")
    vocab = {name: torch.as_tensor(a, device=device) if isinstance(a, np.ndarray) else a
             for name, a in vocab.items()}
    mvec = metric.compute(np.asarray(inertia, dtype=np.float64))
    cls_norms = normalizations(distance, mvec, class_coords)

    def f32(x):  # C order: the kernels take contiguous tensors
        return torch.as_tensor(np.ascontiguousarray(x, dtype=np.float32), device=device)

    return ClassifierParams(
        twister=twister,
        metric=f32(mvec),
        class_coords=f32(class_coords),
        class_norms=f32(cls_norms),
        k=space.k,
        canonical=space.canonical,
        base=space.base,
        distance_kind=distance.kind,
        **vocab,
        **extra,
    )


def bf16_aligned(twister: torch.Tensor) -> bool:
    """Whether every row of ``twister`` starts on 16 bytes, its columns
    contiguous: the layout of :func:`bf16_rows`, which the bag kernel
    needs of a bf16 twister."""
    row_bytes = twister.stride(0) * twister.element_size()
    return twister.stride(1) == 1 and row_bytes % 16 == 0 and twister.data_ptr() % 16 == 0


def bf16_rows(twister: torch.Tensor, device: torch.device | str | None = None) -> torch.Tensor:
    """``twister [V, d]`` (f32 or bf16) as a bf16 twister on ``device`` (the
    twister's own by default) whose rows start every ``ld`` elements, d
    rounded up to :data:`BF16_ROW_ALIGN`: a ``[V, d]`` view of a ``[V, ld]``
    buffer, its padding 0.  The cast is made where the twister lies, into
    the padded rows, so only the bf16 twister crosses to ``device``.  Every
    row starts on 16 bytes, so the bag kernel reads it by aligned words;
    the dense route's product takes the row stride as it is."""
    V, d = twister.shape
    ld = -(-d // BF16_ROW_ALIGN) * BF16_ROW_ALIGN
    buf = torch.empty((V, ld), dtype=torch.bfloat16, device=twister.device)
    buf[:, d:].zero_()
    buf[:, :d].copy_(twister)
    return buf.to(twister.device if device is None else device)[:, :d]


def wide_vocab(space: KmerSpace, kmer_codes: np.ndarray) -> tuple[dict, np.ndarray]:
    """The large-k vocabulary of the uint64 k-mer codes (the large-k branch
    of the JAX ``build_classifier_params``): ``vocab_lut=None`` and either
    ``cuckoo`` with ``cuckoo_seeds`` or ``vocab_hi``/``vocab_lo``, as host
    arrays, and the stable sort order that the twister's rows take."""
    _k_hi, k_lo = split_k(space.k, space.base)
    limb = np.uint64(space.base**k_lo)
    order = np.argsort(kmer_codes, kind="stable")
    sorted_codes = kmer_codes[order]
    sorted_hi = (sorted_codes // limb).astype(np.int32)
    sorted_lo = (sorted_codes % limb).astype(np.int32)
    vocab = dict(vocab_lut=None)
    built = build_cuckoo(sorted_hi, sorted_lo)
    if built is not None:
        vocab.update(cuckoo=built[0], cuckoo_seeds=built[1])
    else:  # pathological vocabulary: binary search in the sorted limbs
        vocab.update(vocab_hi=sorted_hi, vocab_lo=sorted_lo)
    return vocab, order


def params_from_jax(
    arrays: dict[str, np.ndarray],
    k: int,
    canonical: bool,
    base: int,
    distance_kind: str,
    device: torch.device | str | None = None,
    cuckoo_seeds: tuple = (),
) -> ClassifierParams:
    """Carry the JAX package's ``ClassifierParams`` across: ``arrays`` holds
    its array fields (:data:`PARAM_ARRAYS`, those that are None left out or
    None) as numpy arrays (``np.asarray(field)``); ``cuckoo_seeds`` is its
    field of that name.  A bf16 twister (numpy's ``bfloat16`` of
    ``ml_dtypes``, which numpy has no type of its own for) crosses as its
    16 bits."""
    from ..config import device as default_device

    device = default_device() if device is None else torch.device(device)
    tw_dtype = np.asarray(arrays["twister"]).dtype
    if tw_dtype != np.float32 and tw_dtype.name != "bfloat16":
        raise NotImplementedError(f"{tw_dtype} twisters: the port serves f32 and bf16 ones")

    def t(name):
        # a C-order copy: arrays taken from JAX are read-only
        a = arrays.get(name)
        if a is None:
            return None
        a = np.ascontiguousarray(a)
        if a.dtype.name == "bfloat16":  # its 16 bits, into aligned rows
            return bf16_rows(torch.tensor(a.view(np.uint16)).view(torch.bfloat16), device)
        return torch.tensor(a, device=device)

    return ClassifierParams(
        **{name: t(name) for name in PARAM_ARRAYS},
        k=k,
        canonical=canonical,
        base=base,
        distance_kind=distance_kind,
        cuckoo_seeds=cuckoo_seeds,
    )


def vocab_lookup(params: ClassifierParams, base_codes: torch.Tensor) -> torch.Tensor:
    """``[B, L]`` base codes -> vocabulary index ``[B, W]`` in [0..V], with
    V for a miss or an invalid window (plain PyTorch): the dense table up
    to k = :func:`~.encode.lut_k_max`, else the two-limb codes in the
    cuckoo hash or, without one, the sorted limbs."""
    V = params.n_vocab
    if params.vocab_lut is not None:
        codes, ok = window_codes_batch(base_codes, params.k, params.canonical, params.base)
        idx = params.vocab_lut[codes.long()]
    else:
        hi, lo, ok = window_codes_batch_wide(base_codes, params.k, params.canonical, params.base)
        if params.cuckoo is not None:
            idx = cuckoo_lookup_ref(params.cuckoo, params.cuckoo_seeds, V, hi, lo)
        else:
            idx = searchsorted_2limb(params.vocab_hi, params.vocab_lo, hi, lo)
    return torch.where(ok, idx, torch.full_like(idx, V))


def _check_codes(name: str, params: ClassifierParams, reads):
    """``(B, L)`` of int8 codes ``[B, L]`` or :class:`~.encode.PackedReads`,
    checked: on the 2-bit wire, u8 tensors on one device whose strides
    match ``L``, and DNA (base 4); ``L`` from k to
    :data:`~.encode.READ_MAX_BASES`."""
    if isinstance(reads, PackedReads):
        packed, valid, L = reads
        ps, vs = packed_strides(L)
        if packed.dtype != torch.uint8 or valid.dtype != torch.uint8 or packed.dim() != 2 \
                or packed.shape[1] != ps or valid.shape != (packed.shape[0], vs):
            raise TypeError(
                f"{name}: packed reads of length {L} must be u8 [B, {ps}] and [B, {vs}], got "
                f"{packed.dtype} {tuple(packed.shape)} and {valid.dtype} {tuple(valid.shape)}"
            )
        if valid.device != packed.device or not (packed.is_contiguous() and valid.is_contiguous()):
            raise ValueError(f"{name}: packed and valid must be contiguous, on one device")
        if params.base != 4:
            raise ValueError(f"{name}: the 2-bit wire holds DNA, not base {params.base}")
    elif reads.dim() != 2 or reads.dtype != torch.int8:
        raise TypeError(
            f"{name}: base codes must be a [B, L] int8 tensor, got "
            f"{reads.dtype} {tuple(reads.shape)}"
        )
    B, L = reads.shape
    if L < params.k:
        raise ValueError(f"sequences shorter than k: L={L}, k={params.k}")
    check_row_length(name, L)
    return B, L


def wire_args(reads, b0: int = 0) -> tuple[str, tuple]:
    """The C entry point's wire suffix and its read-set pointers from read
    set ``b0`` on: ``("", (codes,))`` for int8 codes, ``("_packed",
    (packed, valid))`` for the 2-bit wire, each at its own row stride."""
    if isinstance(reads, PackedReads):
        ps, vs = packed_strides(reads.length)
        return "_packed", (reads.packed.data_ptr() + b0 * ps, reads.valid.data_ptr() + b0 * vs)
    return "", (reads.data_ptr() + b0 * reads.shape[1],)


def _row_range(params: ClassifierParams, row0: int, rows: int | None) -> int:
    """``rows`` of a count's row range, checked (None: to the vocabulary's
    end)."""
    V = params.n_vocab
    rows = V - row0 if rows is None else int(rows)
    if row0 < 0 or rows < 0 or row0 + rows > _INT_MAX:
        raise ValueError(f"count_spectra: bad row range row0={row0}, rows={rows} (V={V})")
    return rows


def count_spectra_ref(params: ClassifierParams, base_codes: torch.Tensor, row0: int = 0,
                      rows: int | None = None, known: bool = False):
    """Plain PyTorch version of :func:`count_spectra`.  A read that repeats
    a k-mer counts it every time: ``index_put_(accumulate=True)``, not
    ``out[idx] += 1``, which would collapse duplicates.  Each cell is
    counted in int64 and converted to f32 once, as the kernel's integer
    counters are: exact below 2^24, one rounding above."""
    V = params.n_vocab
    rows = _row_range(params, row0, rows)
    idx = vocab_lookup(params, base_codes)
    B, W = idx.shape
    at = torch.arange(B, device=idx.device)[:, None].expand(B, W)
    hit = idx < V
    kept = hit & (idx >= row0) & (idx < row0 + rows)
    out = torch.zeros((B, rows), dtype=torch.int64, device=idx.device)
    ones = torch.ones(int(kept.sum()), dtype=torch.int64, device=idx.device)
    out = out.index_put_((at[kept], idx[kept].long() - row0), ones, accumulate=True).float()
    return (out, hit.sum(dim=1, dtype=torch.int32)) if known else out


class CountPlan(NamedTuple):
    """The count kernel's plan (:func:`count_plan`)."""

    bits: int  #: counter bits
    cells: int  #: cells a slice
    slices: int  #: slices of the counted rows
    bucket: bool  #: the bucketed plan, else the read-all one


def count_plan(W: int, rows: int) -> CountPlan:
    """The count kernel's plan for read sets of ``W`` windows into ``rows``
    vocabulary rows: counter bits (16 while no cell can exceed 65,535, else
    32), cells a slice of ``COUNT_SLICE_BYTES``, slices, and whether it
    buckets.

    The read-all plan has each (slice, read set) task read the read set's
    whole row of kept indices, so a row is read once a slice; the bucketed
    plan sorts each row by slice first (a histogram, a scan and a scatter:
    three more launches, the row read twice more and written once), so a
    task reads only its bucket.  The count buckets where the read sets take
    u32 counters (more than ``COUNT_NARROW_MAX`` windows) and the rows span
    more than one slice and at most :data:`COUNT_BUCKET_SLICES` (its
    scatter's bins).  The cut follows the counter width because that is
    where the measurements on an H100 split: bucketed was faster at every
    u32 shape probed (by 8 % at 65,536 windows a read set, 1.8x at
    sars2-reads' 601,876 windows and 22 slices, 4.9x at 88.8M windows and
    342 slices), read-all at six of the seven u16 shapes (by 3-21 %,
    sars2-genomes' 8 % among them); the seventh, real reads at k = 16 with
    93 % of their windows kept, ran 5 % faster bucketed.  Which plan wins
    at u16 turns on how many windows the vocabulary keeps, which the host
    does not see before the lookup."""
    bits = 16 if W <= COUNT_NARROW_MAX else 32
    cells = COUNT_SLICE_BYTES * 8 // bits
    slices = -(-rows // cells)
    return CountPlan(bits, cells, slices, bits == 32 and 1 < slices <= COUNT_BUCKET_SLICES)


def count_tasks(B: int, slices: int, sizes=None) -> list[int]:
    """The order in which the count kernel's queue hands out its ``slices *
    B`` (slice, read set) tasks, task ``s B + b``; each block of its one
    wave takes the next task as it finishes one.  The read-all plan
    (``sizes`` None) is slice-major.  The bucketed plan takes the ``[B,
    slices]`` bucket sizes and queues a task larger than twice its read
    set's mean bucket first, the rest after; the kernel queues each group
    in any order (here in task order)."""
    tasks = range(slices * B)
    if sizes is None:
        return list(tasks)
    n = [sum(row) for row in sizes]
    big = [sizes[t % B][t // B] * slices > 2 * n[t % B] for t in tasks]
    return [t for t in tasks if big[t]] + [t for t in tasks if not big[t]]


def count_scratch_ints(B: int, L: int, k: int, rows: int, bucket: bool | None = None) -> int:
    """The count kernel's int32 scratch for ``B`` read sets of ``L``
    positions into ``rows`` vocabulary rows: each read set's count of kept
    windows (the known windows in the row range), its count of all known
    windows, the task queue (two ints) and the bucket queue's head and
    tail; in the bucketed plan each bucket's end, its start and the queue
    of tasks (``B`` times the slices each); padded to 4 ints; then each
    read set's row of ``Wp`` (its windows rounded up to ``COUNT_RUN``),
    where the lookup appends the vocabulary indices of the kept windows
    (less the range's first row), and in the bucketed plan a second such
    row, where they are sorted by slice.  The plan is :func:`count_plan`'s
    unless ``bucket`` names one."""
    W = L - k + 1
    Wp = -(-max(W, 0) // COUNT_RUN) * COUNT_RUN
    plan = count_plan(W, rows)
    bucket = plan.bucket if bucket is None else bucket
    BS = B * plan.slices if bucket else 0
    return -(-(2 * B + 4 + 3 * BS) // 4) * 4 + B * Wp * (2 if bucket else 1)


def count_workspace(B: int, L: int, k: int, rows: int, device) -> tuple[int, torch.Tensor]:
    """What a launch of the count's C entry points takes for ``B`` read
    sets of ``L`` positions into ``rows`` vocabulary rows before its
    output: the plan (1 bucketed, 0 read-all: :func:`count_plan`) and an
    int32 scratch laid out for that plan (:func:`count_scratch_ints`)."""
    bucket = count_plan(L - k + 1, rows).bucket
    ints = count_scratch_ints(B, L, k, rows, bucket)
    return int(bucket), torch.empty(ints, dtype=torch.int32, device=device)


def row_groups(B: int, rows: int) -> list[tuple[int, int]]:
    """Read sets ``[0, B)`` in consecutive groups ``(b0, b1)`` of at most
    ``rows``: the launches of a kernel whose batch is limited, each into
    the rows ``out[b0:b1]`` of a row-major output.  Each output row depends
    only on its own read set."""
    return [(b0, min(B, b0 + rows)) for b0 in range(0, B, rows)] or [(0, 0)]


def count_row_groups(B: int) -> list[tuple[int, int]]:
    """The count kernel's launches for a batch of ``B`` read sets: groups of
    at most :data:`COUNT_MAX_ROWS`, its grid's limit."""
    return row_groups(B, COUNT_MAX_ROWS)


def bag_row_groups(B: int, W: int) -> list[tuple[int, int]]:
    """The bag kernel's launches for ``B`` read sets of ``W`` windows: one
    launch for the whole batch (the kernel walks it in passes of
    :data:`BAG_GROUP`) while ``2 BAG_GROUP W`` fits in the int32 that
    indexes a pass's keys and entries; above that (``W`` > 8,388,607 at
    ``BAG_GROUP`` = 128) groups of the largest ``Bg`` with ``2 Bg W <=
    2^31 - 1`` (12 read sets of 88.8M windows).  Read sets of more than
    :data:`BAG_MAX_WINDOWS` windows, of which not one fits, raise a
    ``ValueError``."""
    if W > BAG_MAX_WINDOWS:
        raise ValueError(f"project_reads: {W} windows a read set; the bag takes at most "
                         f"{BAG_MAX_WINDOWS} (int32 keys, 2 a window)")
    rows = min(BAG_GROUP, _INT_MAX // (2 * max(W, 1)))
    return [(0, B)] if rows >= BAG_GROUP else row_groups(B, rows)


def count_spectra(params: ClassifierParams, base_codes, row0: int = 0,
                  rows: int | None = None, known: bool = False):
    """``[B, L]`` int8 base codes, or DNA read sets on the 2-bit wire
    (:class:`~.encode.PackedReads`), -> vocabulary-aligned spectra ``[B,
    V]`` f32, the same from either.  Each cell is counted as an integer and
    converted to f32 once: exact below 2^24, one f32 rounding above.  Read
    sets of up to :data:`~.encode.READ_MAX_BASES` positions are taken (a
    longer one raises a ``ValueError``); a batch's offsets are 64-bit.  A
    batch above :data:`COUNT_MAX_ROWS` read sets is counted in groups
    (:func:`count_row_groups`).

    ``row0`` and ``rows`` count only the vocabulary rows ``[row0, row0 +
    rows)`` into ``[B, rows]`` spectra (a k-mer-sharded rank's,
    :mod:`..parallel.serving`; rows past the vocabulary count nothing);
    the default is the whole vocabulary.  With ``known`` it returns
    ``(spectra, [B] int32 counts of each read set's known windows)``: all
    of them, in the range or not, exact, the normaliser of
    :func:`project` (and of a shard's projection).  On the whole
    vocabulary the kernel keeps every known window, so that count is the
    one it keeps anyway.

    On a card, ``csrc/count_spectra.cu``: each window is looked up once
    and the kept ones' indices appended to an int32 scratch
    (:func:`count_workspace`); on long read sets they are then sorted
    into a bucket a vocabulary slice (:func:`count_plan`); then one wave of
    blocks takes the (slice, read set) tasks from a queue
    (:func:`count_tasks`), counts each in shared memory from its bucket (or
    from the read set's whole row) and writes its slice whole, so the
    output needs no zeroing.  The 2-bit wire takes the kernel's
    ``_packed`` entry points, which read each base from the packed bytes
    where the int8 ones read a code; on the CPU it is unpacked
    (:func:`~.encode.unpack_2bit_batch`) for the plain version."""
    B, L = _check_codes("count_spectra", params, base_codes)
    if base_codes.device.type == "cpu":
        return count_spectra_ref(params, as_codes(base_codes), row0, rows, known)
    rows = _row_range(params, row0, rows)
    suffix, vocab = vocab_args("count_spectra", params, base_codes)
    V = params.n_vocab
    ranged = row0 != 0 or rows != V
    dev = base_codes.device
    groups = count_row_groups(B)
    Bg = max(b1 - b0 for b0, b1 in groups)
    bucket, scratch = count_workspace(Bg, L, params.k, rows, dev)
    out = torch.empty((B, rows), dtype=torch.float32, device=dev)
    n_known = torch.empty(B, dtype=torch.int32, device=dev) if known else None
    out_p = out.data_ptr()
    for b0, b1 in groups:  # each group from and into its rows (f32 out)
        wire, reads = wire_args(base_codes, b0)
        _build.launch(
            "kpop_count_spectra" + suffix + wire,
            *reads, b1 - b0, L, params.k, int(params.canonical),
            params.base, *vocab, V, row0, rows, int(known), bucket, scratch.data_ptr(),
            out_p + 4 * b0 * rows,
        )
        if known:  # a launch of n read sets: n kept counts, then n known counts
            n = b1 - b0
            at = n if ranged else 0
            n_known[b0:b1] = scratch[at : at + n]
    return (out, n_known) if known else out


def vocab_args(name: str, params: ClassifierParams, base_codes):
    """The C entry point's suffix and its vocabulary arguments, after
    checking the tensors' devices and dtypes (the read sets': int8 codes or
    the 2-bit wire's u8 pair): ``("", (lut,))`` for the dense table, else
    ``("_wide", (k_lo, probe, slots, a1, b1, a2, b2, limbs))`` with a null
    pointer for the lookup not taken (``probe``: the cuckoo table's
    :func:`~.cuckoo.probe_table` layout; ``limbs``: the sorted ``[V, 2]``
    limbs)."""
    if isinstance(base_codes, PackedReads):
        reads, dtypes = (base_codes.packed, base_codes.valid), (torch.uint8, torch.uint8)
    else:
        reads, dtypes = (base_codes,), (torch.int8,)
    if params.vocab_lut is not None:
        table, suffix, vocab = params.vocab_lut, "", (params.vocab_lut.data_ptr(),)
    else:
        _k_hi, k_lo = split_k(params.k, params.base)
        if params.cuckoo is not None:
            table, suffix = params.cuckoo_probe, "_wide"
            vocab = (k_lo, params.cuckoo_probe.data_ptr(), params.cuckoo.shape[1],
                     *params.cuckoo_seeds, None)
        else:
            table, suffix = params.vocab_limbs, "_wide"
            vocab = (k_lo, None, 0, 0, 0, 0, 0, params.vocab_limbs.data_ptr())
    _build.check_cuda(name, *reads, table, dtypes=(*dtypes, torch.int32))
    return suffix, vocab


def check_whole_twister(name: str, params: ClassifierParams) -> None:
    """Raise unless ``params`` hold the whole twister: a rank's shard of
    k-mer-sharded serving is projected by :mod:`..parallel.serving`."""
    if params.row0 != 0 or params.twister.shape[0] != params.n_vocab:
        raise ValueError(
            f"{name}: the parameters hold twister rows [{params.row0}, "
            f"{params.row0 + params.twister.shape[0]}) of {params.n_vocab}, a shard of "
            "k-mer-sharded serving (parallel/serving.py::sharded_dmat_fn)"
        )


def project_reads_ref(
    params: ClassifierParams,
    base_codes: torch.Tensor,
    normalize: bool = True,
    chunk: int = 2048,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`project_reads`: gather-sum of twister
    rows over chunks of ``chunk`` windows (the JAX ``lax.scan``), each row
    widened to f32 and summed in f32."""
    check_whole_twister("project_reads", params)
    V = params.n_vocab
    idx = vocab_lookup(params, base_codes)
    B, W = idx.shape
    known = idx < V
    twisted = torch.zeros(
        (B, params.twister.shape[1]), dtype=torch.float32, device=idx.device
    )
    for w0 in range(0, W, chunk):
        safe = idx[:, w0 : w0 + chunk].clamp(max=V - 1).long()
        contrib = params.twister[safe] * known[:, w0 : w0 + chunk, None]
        twisted += contrib.sum(dim=1, dtype=torch.float32)  # a bf16 row widened
    return normalized(twisted, known.sum(dim=1)) if normalize else twisted


def normalized(out: torch.Tensor, known: torch.Tensor) -> torch.Tensor:
    """``out [B, d]`` f32 divided by ``known [B]``, each read set's count of
    known windows (an integer; 0 becomes 1), once, in float64: the
    correctly rounded f32 quotient at any count, and below 2^24 the same
    bits as an f32 division (lib/Twister.ml:173-183)."""
    n = known.to(torch.float64).clamp(min=1.0)
    return (out.to(torch.float64) / n[:, None]).to(torch.float32)


def bag_workspace_ints(B: int, L: int, k: int, V: int) -> int:
    """int32 workspace of the bag kernel: with ``T = ceil(V /
    BAG_TILE_ROWS)`` tiles and ``N = min(B, BAG_GROUP) (L - k + 1)``
    windows a pass, tile meta,
    hit masks and headers (``BAG_GROUP + 16`` ints a tile), the
    ``BAG_COUNTERS`` counters of each tile, 2 N + 2 of entries (the
    windows' rows first), N keys, 3 T + 1 of the tiles that hold keys, their
    key offsets and the tiles' totals, and ``BAG_GROUP + 2`` counts.  The
    same layout as the kernel's."""
    T = -(-V // BAG_TILE_ROWS)
    N = min(B, BAG_GROUP) * (L - k + 1)
    return (BAG_GROUP + 19 + BAG_COUNTERS) * T + 3 * N + BAG_GROUP + 5


def bag_regime(entries: int, tiles: int) -> str:
    """The accumulate the bag kernel takes for a pass of ``entries``
    distinct (row, read set) pairs in ``tiles`` vocabulary tiles of
    :data:`BAG_TILE_ROWS` rows that hold keys: ``"gather"`` where a tile
    holds at most :data:`BAG_GATHER_TILE_ENTRIES` entries on average
    (random reads at k = 16: 108; real reads at k = 16: 225), else
    ``"staged"`` (the kernel decides on the card from the same counts)."""
    return "gather" if entries <= BAG_GATHER_TILE_ENTRIES * tiles else "staged"


def bag_plan(V: int, d: int, n_sm: int = H100_SMS) -> int:
    """The vocabulary slices ``S`` of the bag kernel, so that ``S`` times
    the ``ceil(d / BAG_COLS)`` column blocks fill the ``n_sm`` SMs once (an
    accumulate block takes an SM's shared memory; at least 1 slice, at
    most one a tile of ``BAG_TILE_ROWS`` rows, and within CUDA's
    grid.y)."""
    col_blocks = -(-d // BAG_COLS)
    return max(1, min(-(-V // BAG_TILE_ROWS), 65535, n_sm // col_blocks))


def project_reads(params: ClassifierParams, base_codes, normalize: bool = True) -> torch.Tensor:
    """Reads -> twisted coordinates ``[B, d]`` without spectra:
    ``twisted[b] = sum_w twister[lut[code_w]] / n_known`` (unknown k-mers
    drop out, duplicates accumulate; lib/Twister.ml:146-188).

    On a card, ``csrc/embedding_bag.cu``: each pass of ``BAG_GROUP`` read
    sets buckets its known windows by vocabulary tile, turns each tile
    into exact integer counts, and adds count x row to the read sets that
    hit each row: through a ring in shared memory that reads each hit row
    once per column block, or, where the vocabulary tiles are sparse
    (:func:`bag_regime`), straight from global memory into registers;
    the :func:`bag_plan` slices of the vocabulary are summed in order.
    The result is the same from run to run, and in either regime.  A bf16
    twister's rows are read at 2 bytes an element and widened to f32 in
    the kernel, before the same f32 products and sums, by aligned 8-byte
    words: its rows must start on 16 bytes (:func:`bf16_aligned`; a
    :class:`ClassifierParams` lays them out so), or it raises.  Each
    (read set, row) count is an integer until it multiplies its row, in
    f32 (exact below 2^24, one rounding above), and each read set's sum is
    divided once by its integer count of known windows (:func:`normalized`).
    Read sets of more than 8,388,607 windows are taken in smaller groups,
    and of more than :data:`BAG_MAX_WINDOWS` raise a ``ValueError``
    (:func:`bag_row_groups`).  DNA read sets on the 2-bit wire
    (:class:`~.encode.PackedReads`) take the kernel's ``_packed`` entry
    points, with the same result; on the CPU they are unpacked for the
    plain version."""
    B, L = _check_codes("project_reads", params, base_codes)
    check_whole_twister("project_reads", params)
    groups = bag_row_groups(B, L - params.k + 1)
    if base_codes.device.type == "cpu":
        return project_reads_ref(params, as_codes(base_codes), normalize)
    suffix, vocab = vocab_args("project_reads", params, base_codes)
    tw = params.twister
    if tw.device != base_codes.device or tw.stride(1) != 1 or tw.stride(0) < tw.shape[1]:
        raise ValueError("project_reads: the twister must lie on the codes' device in rows of "
                         "contiguous columns")
    if tw.data_ptr() % 16:
        raise ValueError("project_reads: the twister must start on 16 bytes (bulk copies)")
    if tw.dtype == torch.bfloat16 and not bf16_aligned(tw):
        raise ValueError("project_reads: a bf16 twister's rows must each start on 16 bytes "
                         f"(row stride {tw.stride(0)}); lay it out with pipeline.bf16_rows")
    V, d = tw.shape
    Bg = min(BAG_GROUP, max(b1 - b0 for b0, b1 in groups))
    S = bag_plan(V, d, _sm_count(base_codes.device))
    dev = base_codes.device
    iwork = torch.empty(bag_workspace_ints(Bg, L, params.k, V), dtype=torch.int32, device=dev)
    fwork = torch.empty(S * Bg * d, dtype=torch.float32, device=dev)
    out = torch.empty((B, d), dtype=torch.float32, device=dev)
    out_p = out.data_ptr()
    for b0, b1 in groups:  # each group from and into its rows (f32 out)
        wire, reads = wire_args(base_codes, b0)
        _build.launch(
            "kpop_embedding_bag" + suffix + wire,
            *reads, b1 - b0, L, params.k, int(params.canonical),
            params.base, *vocab, V,
            tw.data_ptr(), BAG_ROW_TYPES[tw.dtype], d, tw.stride(0), int(normalize),
            S, iwork.data_ptr(), fwork.data_ptr(), out_p + 4 * b0 * d,
        )
    return out


def project(
    params: ClassifierParams, spectra: torch.Tensor, normalize: bool = True,
    known: torch.Tensor | None = None,
) -> torch.Tensor:
    """Spectra ``[B, V]`` -> twisted coordinates ``[B, d]``: an f32 product
    with the twister, divided by each row's total count (lib/Twister.ml:
    173-183; linear, so the small output is divided, not the spectrum).

    The total is ``known``, each read set's integer count of its known
    windows (``count_spectra(..., known=True)``), or without it the
    spectrum's float64 row sum (exact while its cells are); either is
    divided once (:func:`normalized`).  With a bf16 twister the f32
    spectrum is cast to bf16, as the JAX package's ``astype`` does (counts
    above 256 round), and multiplied with an f32 output
    (:func:`bf16_product`)."""
    check_whole_twister("project", params)
    if params.twister.dtype == torch.bfloat16:
        out = bf16_product(spectra.to(torch.bfloat16), params.twister)
    else:
        out = spectra @ params.twister
    if not normalize:
        return out
    return normalized(out, spectra.sum(dim=1, dtype=torch.float64) if known is None else known)


def bf16_product_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`bf16_product`: the f32 product of the
    widened values."""
    return a.float() @ b.float()


def bf16_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``[B, V]`` bf16 x ``[V, d]`` bf16 -> ``[B, d]`` f32: the JAX
    package's ``jnp.dot(..., preferred_element_type=float32)``.  On a card
    one cuBLAS GEMM with f32 accumulation and an f32 output
    (``aten::mm.dtype``), with no f32 copy of either operand and no bf16
    rounding of the result; on the CPU, where torch has no such kernel,
    :func:`bf16_product_ref`."""
    if a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16:
        raise TypeError(f"bf16_product: bf16 operands, got {a.dtype} and {b.dtype}")
    if a.device.type == "cpu":
        return bf16_product_ref(a, b)
    return torch.mm(a, b, out_dtype=torch.float32)


def distances_to_classes(
    params: ClassifierParams, twisted: torch.Tensor, normalize: bool = True
) -> torch.Tensor:
    """Metric-weighted euclidean or cosine distances ``[B, C]``.

    Euclidean goes through the distance-tile kernel with the query norms
    computed here and the class norms of the parameters.  Cosine is the
    plain expansion halved, with halved norms (lib/Space.ml:150-205), as
    the JAX package sends only euclidean to its Pallas kernel.
    """
    m = params.metric
    if params.distance_kind == "euclidean":
        B, C = twisted.shape[0], params.class_coords.shape[0]
        if normalize:
            na, nb = row_norms(twisted, m), params.class_norms
        else:
            na = torch.ones(B, dtype=torch.float32, device=twisted.device)
            nb = torch.ones(C, dtype=torch.float32, device=twisted.device)
        return distance_tile(twisted.contiguous(), params.class_coords, m, na, nb)
    a = twisted
    if normalize:
        na = (a * a * m[None, :]).sum(dim=1) / 2.0
        na = torch.where(na == 0.0, torch.ones_like(na), na)
        a = a / na[:, None]
        b = params.class_coords / params.class_norms[:, None]
    else:
        b = params.class_coords
    am = a * m[None, :]
    cross = am @ b.T
    na2 = (am * a).sum(dim=1)
    nb2 = (b * b * m[None, :]).sum(dim=1)
    return torch.clamp(na2[:, None] + nb2[None, :] - 2.0 * cross, min=0.0) / 2.0


def summarize_batch(dmat: torch.Tensor, req_len: int = 2):
    """Per-query digest (lib/Matrix.ml:632-690): mean, stddev (n-1), upper
    median (index C//2 of the sorted row), MAD of the same convention, and
    the ``req_len`` smallest distances with their indices.  ``torch.median``
    returns the lower median, so the row is sorted and indexed instead.
    The nearest come from the same stable sort, so ties are taken lowest
    index first, as the JAX package's ``lax.top_k(-dmat)`` takes them
    (``torch.topk`` leaves their order unspecified)."""
    B, C = dmat.shape
    mean = dmat.mean(dim=1)
    stddev = torch.sqrt(((dmat - mean[:, None]) ** 2).sum(dim=1) / max(C - 1, 1))
    srt, order = torch.sort(dmat, dim=1, stable=True)
    median = srt[:, C // 2]
    mad = torch.sort(torch.abs(dmat - median[:, None]), dim=1).values[:, C // 2]
    r = min(req_len, C)
    return mean, stddev, median, mad, srt[:, :r], order[:, :r]


def classify_step(
    vocab_lut,
    twister,
    metric,
    class_coords,
    class_norms,
    base_codes,
    *,
    k: int,
    canonical: bool,
    normalize: bool = True,
    req_len: int = 2,
):
    """The full pipeline on raw tensors: digest of the distances plus the
    twisted coordinates."""
    params = ClassifierParams(
        vocab_lut, twister, metric, class_coords, class_norms, k, canonical
    )
    spectra = count_spectra(params, base_codes)
    twisted = project(params, spectra, normalize=normalize)
    dmat = distances_to_classes(params, twisted, normalize=normalize)
    return (*summarize_batch(dmat, req_len), twisted)


def classify_step_packed(
    vocab_lut,
    twister,
    metric,
    class_coords,
    class_norms,
    packed,
    valid,
    *,
    length: int,
    k: int,
    canonical: bool,
    normalize: bool = True,
    req_len: int = 2,
):
    """:func:`classify_step` on DNA read sets of ``length`` bases on the
    2-bit wire (``packed``, ``valid``: :class:`~.encode.PackedReads`), the
    counterpart of ``bench.py``'s ``step_packed``: the kernels read the
    wire as it is, where the JAX package unpacks it first.  The same
    tuple."""
    params = ClassifierParams(
        vocab_lut, twister, metric, class_coords, class_norms, k, canonical
    )
    reads = PackedReads(packed, valid, length)
    twisted = project(params, count_spectra(params, reads), normalize=normalize)
    dmat = distances_to_classes(params, twisted, normalize=normalize)
    return (*summarize_batch(dmat, req_len), twisted)


def _forward_step(params: ClassifierParams, base_codes, req_len: int):
    spectra, known = count_spectra(params, base_codes, known=True)
    twisted = project(params, spectra, known=known)
    dmat = distances_to_classes(params, twisted)
    return (*summarize_batch(dmat, req_len), twisted, dmat)


class TorchClassifier:
    """Host reads in, per-batch device classification out."""

    def __init__(self, params: ClassifierParams, req_len: int = 2):
        self.params = params
        self.req_len = req_len

    def classify_codes(self, base_codes: np.ndarray):
        """``[B, L]`` base codes -> numpy (mean, std, median, MAD, top
        distances, top indices, twisted, distances)."""
        codes = torch.as_tensor(
            np.ascontiguousarray(base_codes, dtype=np.int8),
            device=self.params.twister.device,
        )
        out = _forward_step(self.params, codes, self.req_len)
        return tuple(t.cpu().numpy() for t in out)

    def classify_packed(self, packed: np.ndarray, valid: np.ndarray, length: int):
        """:meth:`classify_codes` of DNA read sets of ``length`` bases on
        the 2-bit wire (:func:`~.encode.pack_reads_2bit`); the same
        tuple."""
        dev = self.params.twister.device
        reads = PackedReads(
            *(torch.as_tensor(np.ascontiguousarray(a, dtype=np.uint8), device=dev)
              for a in (packed, valid)),
            length,
        )
        out = _forward_step(self.params, reads, self.req_len)
        return tuple(t.cpu().numpy() for t in out)
