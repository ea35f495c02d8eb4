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
f32 ``torch.matmul``, as the JAX package left it to XLA.

Up to k = :func:`~.encode.lut_k_max` a window code is looked up in a dense
table; above it (DNA k up to 30, protein up to 12) its two int32 limbs are
looked up in a cuckoo hash or, when the hash could not be built, by binary
search in the sorted limbs.  The count and the bag each have a second C
entry point for that lookup (``kpop_count_spectra_wide``,
``kpop_embedding_bag_wide``; ``csrc/wide_lookup.cuh``).

Not ported yet (they raise): bf16 twisters.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..core.kmers import KmerSpace
from ..core.space import Distance, Metric, normalizations
from ..core.twister import Twister

from .. import _build
from .cuckoo import build_cuckoo, cuckoo_lookup_ref
from .encode import (
    lut_k_max,
    searchsorted_2limb,
    split_k,
    window_codes_batch,
    window_codes_batch_wide,
)
from .pairwise import H100_SMS, _sm_count, distance_tile, row_norms

ROADMAP_NOTE = "not ported to kpop_tpu_torch yet (ROADMAP.md, queue 1)"

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
#: windows a thread of the count kernel (csrc/count_spectra.cu) looks up
#: and merges; the index scratch pads each read set to a multiple of it
COUNT_RUN = 8
#: shared-memory bytes of counters a block of the count kernel holds: one
#: slice of the vocabulary
COUNT_SLICE_BYTES = 96 * 1024
#: most windows a read set for the count kernel's u16 counters
COUNT_NARROW_MAX = 65535
_INT_MAX = 2**31 - 1


class ClassifierParams(nn.Module):
    """Device-resident parameters of the count + twist + classify model.

    Buffers: ``twister [V, d]`` f32, ``metric [d]``, ``class_coords [C,
    d]``, ``class_norms [C]`` and the vocabulary.  Up to k =
    :func:`~.encode.lut_k_max` the vocabulary is ``vocab_lut [base^k + 1]``
    int32 (code -> twister row, V for a k-mer outside the vocabulary).
    Above it (DNA k up to 30, protein up to 12) ``vocab_lut`` is None, the
    twister rows are in the order of the sorted k-mer codes, and a window
    code's two int32 limbs (:func:`~.encode.window_codes_batch_wide`) are
    looked up in ``cuckoo [6, S]`` int32 with its four ``cuckoo_seeds``
    (:mod:`.cuckoo`) or, when the cuckoo build failed, by binary search in
    the sorted limbs ``vocab_hi``/``vocab_lo [V]`` int32.
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
    ):
        super().__init__()
        if twister.dtype != torch.float32:
            raise NotImplementedError(
                f"{twister.dtype} twisters are {ROADMAP_NOTE}: torch.matmul "
                "would return that dtype where the JAX package accumulates "
                "and returns f32"
            )
        if distance_kind not in ("euclidean", "cosine"):
            raise ValueError(
                f"device classification supports euclidean/cosine, "
                f"not {distance_kind!r}"
            )
        V = twister.shape[0]
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
        self.register_buffer("vocab_lut", vocab_lut)
        self.register_buffer("twister", twister)
        self.register_buffer("metric", metric)
        self.register_buffer("class_coords", class_coords)
        self.register_buffer("class_norms", class_norms)
        self.register_buffer("vocab_hi", vocab_hi)
        self.register_buffer("vocab_lo", vocab_lo)
        self.register_buffer("cuckoo", cuckoo)
        self.cuckoo_seeds = tuple(int(s) for s in cuckoo_seeds)
        self.k = k
        self.canonical = canonical
        self.base = base
        self.distance_kind = distance_kind

    @property
    def n_vocab(self) -> int:
        return self.twister.shape[0]


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
) -> ClassifierParams:
    """Assemble device parameters from host artefacts, as the JAX
    ``build_classifier_params`` does: the host ``[d, V]`` twister is
    uploaded as ``[V, d]`` f32, then :func:`params_around_twister`."""
    from ..config import device as default_device

    device = default_device() if device is None else torch.device(device)
    tw = np.asarray(twister.twister.matrix.data, dtype=np.float32).T  # [V, d]
    return params_around_twister(
        space, twister.kmer_names,
        torch.as_tensor(np.ascontiguousarray(tw), device=device),
        np.asarray(twister.inertia.matrix.data[0]), class_coords, distance, metric,
    )


def params_around_twister(
    space: KmerSpace,
    kmer_names: list[str],
    twister: torch.Tensor,
    inertia: np.ndarray,
    class_coords: np.ndarray,
    distance: Distance | None = None,
    metric: Metric | None = None,
) -> ClassifierParams:
    """Classifier parameters around a ``[V, d]`` f32 twister that already
    lies on its device, such as the one ``ca_fit_sharded(phi="device")``
    trains (the train-to-serve handoff of ``bench.py``, without a download).
    Unknown k-mers are routed to V (dropped, lib/Twister.ml:167-169); the
    metric comes from the inertia (lib/Twister.ml:208-209).

    Up to k = :func:`~.encode.lut_k_max` the hex k-mer labels become a
    lookup table over the whole base^k code space.  Above it, as in the
    JAX package: the codes are sorted (a stable argsort), split into limbs
    at ``base**k_lo``, and hashed by :func:`~.cuckoo.build_cuckoo` (or kept
    as sorted limbs when no seed converges); the twister's rows are
    gathered into the sorted order, which briefly holds a second copy of
    the twister on its device."""
    distance = distance or Distance.of_string("euclidean")
    metric = metric or Metric.of_string("powers(1,1,2)")
    kmer_codes = np.array([space.hex_to_code(h) for h in kmer_names], dtype=np.uint64)
    V = len(kmer_codes)
    device = twister.device
    if space.k <= lut_k_max(space.base):
        lut = np.full(space.n_kmers + 1, V, dtype=np.int32)
        lut[kmer_codes.astype(np.int64)] = np.arange(V, dtype=np.int32)
        vocab = dict(vocab_lut=torch.as_tensor(lut, device=device))
    else:
        vocab, order = wide_vocab(space, kmer_codes)
        vocab = {name: torch.as_tensor(a, device=device) if isinstance(a, np.ndarray) else a
                 for name, a in vocab.items()}
        twister = twister.index_select(0, torch.as_tensor(order, device=device))
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
    )


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
    field of that name."""
    from ..config import device as default_device

    device = default_device() if device is None else torch.device(device)
    if np.asarray(arrays["twister"]).dtype != np.float32:
        raise NotImplementedError(
            f"{np.asarray(arrays['twister']).dtype} twisters are {ROADMAP_NOTE}"
        )

    def t(name):
        # a C-order copy: arrays taken from JAX are read-only
        a = arrays.get(name)
        return None if a is None else torch.tensor(np.ascontiguousarray(a), device=device)

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


def _check_codes(name: str, params: ClassifierParams, base_codes: torch.Tensor):
    if base_codes.dim() != 2 or base_codes.dtype != torch.int8:
        raise TypeError(
            f"{name}: base codes must be a [B, L] int8 tensor, got "
            f"{base_codes.dtype} {tuple(base_codes.shape)}"
        )
    B, L = base_codes.shape
    if L < params.k:
        raise ValueError(f"sequences shorter than k: L={L}, k={params.k}")
    return B, L


def count_spectra_ref(params: ClassifierParams, base_codes: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`count_spectra`.  A read that repeats
    a k-mer counts it every time: ``index_put_(accumulate=True)``, not
    ``out[idx] += 1``, which would collapse duplicates."""
    V = params.n_vocab
    idx = vocab_lookup(params, base_codes)
    B, W = idx.shape
    rows = torch.arange(B, device=idx.device)[:, None].expand(B, W)
    known = idx < V
    out = torch.zeros((B, V), dtype=torch.float32, device=idx.device)
    ones = torch.ones(int(known.sum()), dtype=torch.float32, device=idx.device)
    out.index_put_((rows[known], idx[known].long()), ones, accumulate=True)
    return out


def count_plan(W: int, V: int) -> tuple[int, int, int]:
    """The count kernel's plan for read sets of ``W`` windows and a
    vocabulary of ``V``: counter bits (16 while no cell can exceed 65,535,
    else 32), cells a slice of ``COUNT_SLICE_BYTES`` and slices."""
    bits = 16 if W <= COUNT_NARROW_MAX else 32
    cells = COUNT_SLICE_BYTES * 8 // bits
    return bits, cells, -(-V // cells)


def count_spectra(params: ClassifierParams, base_codes: torch.Tensor) -> torch.Tensor:
    """``[B, L]`` int8 base codes -> vocabulary-aligned spectra ``[B, V]``
    f32.  Counts are exact (integers below 2^24 per cell).

    On a card, ``csrc/count_spectra.cu``: each window is looked up once
    into an int32 scratch ``[B, Wp]``, then a block a vocabulary slice
    walks the read sets, counts each in shared memory (:func:`count_plan`)
    and writes its slice whole, so the output needs no zeroing."""
    B, L = _check_codes("count_spectra", params, base_codes)
    if base_codes.device.type == "cpu":
        return count_spectra_ref(params, base_codes)
    suffix, vocab = vocab_args("count_spectra", params, base_codes)
    if B > 65535:
        raise ValueError(f"count_spectra: batch {B} exceeds the kernel's grid")
    W = L - params.k + 1
    if W >= 1 << 24:
        raise ValueError(
            f"count_spectra: {W} windows a read set; a count above 2^24 is not exact in f32"
        )
    V = params.n_vocab
    Wp = -(-W // COUNT_RUN) * COUNT_RUN
    dev = base_codes.device
    scratch = torch.empty(B * Wp, dtype=torch.int32, device=dev)
    out = torch.empty((B, V), dtype=torch.float32, device=dev)
    _build.launch(
        "kpop_count_spectra" + suffix,
        base_codes.data_ptr(), B, L, params.k, int(params.canonical),
        params.base, *vocab, V, scratch.data_ptr(), out.data_ptr(),
    )
    return out


def vocab_args(name: str, params: ClassifierParams, base_codes: torch.Tensor):
    """The C entry point's suffix and its vocabulary arguments, after
    checking the tensors' devices and dtypes: ``("", (lut,))`` for the
    dense table, else ``("_wide", (k_lo, cuckoo, slots, a1, b1, a2, b2,
    vocab_hi, vocab_lo))`` with null pointers for the lookup not taken."""
    if params.vocab_lut is not None:
        _build.check_cuda(name, base_codes, params.vocab_lut, dtypes=(torch.int8, torch.int32))
        return "", (params.vocab_lut.data_ptr(),)
    _k_hi, k_lo = split_k(params.k, params.base)
    if params.cuckoo is not None:
        _build.check_cuda(name, base_codes, params.cuckoo, dtypes=(torch.int8, torch.int32))
        return "_wide", (k_lo, params.cuckoo.data_ptr(), params.cuckoo.shape[1],
                         *params.cuckoo_seeds, None, None)
    _build.check_cuda(name, base_codes, params.vocab_hi, params.vocab_lo,
                      dtypes=(torch.int8, torch.int32, torch.int32))
    return "_wide", (k_lo, None, 0, 0, 0, 0, 0,
                     params.vocab_hi.data_ptr(), params.vocab_lo.data_ptr())


def project_reads_ref(
    params: ClassifierParams,
    base_codes: torch.Tensor,
    normalize: bool = True,
    chunk: int = 2048,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`project_reads`: gather-sum of twister
    rows over chunks of ``chunk`` windows (the JAX ``lax.scan``)."""
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
        twisted += contrib.sum(dim=1)
    if normalize:
        counts = known.sum(dim=1).to(torch.float32)
        twisted /= torch.where(counts == 0, torch.ones_like(counts), counts)[:, None]
    return twisted


def bag_workspace_ints(B: int, L: int, k: int, V: int) -> int:
    """int32 workspace of the bag kernel: with ``T = ceil(V /
    BAG_TILE_ROWS)`` tiles and ``N = min(B, BAG_GROUP) (L - k + 1)``
    windows a pass, tile meta,
    hit masks and headers (``BAG_GROUP + 16`` ints a tile), the
    ``BAG_COUNTERS`` counters of each tile, 2 N + 2 of entries (the
    windows' rows first), N keys, 3 T + 1 of the tiles that hold keys, their
    key offsets and the tiles' totals, and ``BAG_GROUP + 1`` counts.  The
    same layout as the kernel's."""
    T = -(-V // BAG_TILE_ROWS)
    N = min(B, BAG_GROUP) * (L - k + 1)
    return (BAG_GROUP + 19 + BAG_COUNTERS) * T + 3 * N + BAG_GROUP + 4


def bag_plan(V: int, d: int, n_sm: int = H100_SMS) -> int:
    """The vocabulary slices ``S`` of the bag kernel, so that ``S`` times
    the ``ceil(d / BAG_COLS)`` column blocks fill the ``n_sm`` SMs once (an
    accumulate block takes an SM's shared memory; at least 1 slice, at
    most one a tile of ``BAG_TILE_ROWS`` rows, and within CUDA's
    grid.y)."""
    col_blocks = -(-d // BAG_COLS)
    return max(1, min(-(-V // BAG_TILE_ROWS), 65535, n_sm // col_blocks))


def project_reads(
    params: ClassifierParams, base_codes: torch.Tensor, normalize: bool = True
) -> torch.Tensor:
    """Reads -> twisted coordinates ``[B, d]`` without spectra:
    ``twisted[b] = sum_w twister[lut[code_w]] / n_known`` (unknown k-mers
    drop out, duplicates accumulate; lib/Twister.ml:146-188).

    On a card, ``csrc/embedding_bag.cu``: each pass of ``BAG_GROUP`` read
    sets buckets its known windows by vocabulary tile, turns each tile
    into exact integer counts, reads each hit twister row once per column
    block and adds count x row to the read sets that hit it; the
    :func:`bag_plan` slices of the vocabulary are summed in order.  The
    result is the same from run to run."""
    B, L = _check_codes("project_reads", params, base_codes)
    if base_codes.device.type == "cpu":
        return project_reads_ref(params, base_codes, normalize)
    suffix, vocab = vocab_args("project_reads", params, base_codes)
    _build.check_cuda("project_reads", base_codes, params.twister,
                      dtypes=(torch.int8, torch.float32))
    if params.twister.data_ptr() % 16:
        raise ValueError("project_reads: the twister must start on 16 bytes (bulk copies)")
    V, d = params.twister.shape
    W = L - params.k + 1
    Bg = min(B, BAG_GROUP)
    # a window count is exact in an f32 entry below 2^24, and 2 Bg W
    # entries index ints
    if W >= 1 << 24 or 2 * Bg * W > _INT_MAX:
        raise ValueError(
            f"project_reads: {W} windows a read set exceed the kernel's keys"
        )
    S = bag_plan(V, d, _sm_count(base_codes.device))
    dev = base_codes.device
    iwork = torch.empty(bag_workspace_ints(B, L, params.k, V), dtype=torch.int32, device=dev)
    fwork = torch.empty(S * Bg * d, dtype=torch.float32, device=dev)
    out = torch.empty((B, d), dtype=torch.float32, device=dev)
    _build.launch(
        "kpop_embedding_bag" + suffix,
        base_codes.data_ptr(), B, L, params.k, int(params.canonical),
        params.base, *vocab, V,
        params.twister.data_ptr(), d, int(normalize), S,
        iwork.data_ptr(), fwork.data_ptr(), out.data_ptr(),
    )
    return out


def project(
    params: ClassifierParams, spectra: torch.Tensor, normalize: bool = True
) -> torch.Tensor:
    """Spectra ``[B, V]`` -> twisted coordinates ``[B, d]``: an f32 product
    with the twister, divided by each row's total count (lib/Twister.ml:
    173-183; linear, so the small output is divided, not the spectrum)."""
    out = spectra @ params.twister
    if normalize:
        sums = spectra.sum(dim=1)
        out = out / torch.where(sums == 0.0, torch.ones_like(sums), sums)[:, None]
    return out


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
    returns the lower median, so the row is sorted and indexed instead."""
    B, C = dmat.shape
    mean = dmat.mean(dim=1)
    stddev = torch.sqrt(((dmat - mean[:, None]) ** 2).sum(dim=1) / max(C - 1, 1))
    median = torch.sort(dmat, dim=1).values[:, C // 2]
    mad = torch.sort(torch.abs(dmat - median[:, None]), dim=1).values[:, C // 2]
    top, idx = torch.topk(dmat, min(req_len, C), dim=1, largest=False, sorted=True)
    return mean, stddev, median, mad, top, idx


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


def _forward_step(params: ClassifierParams, base_codes: torch.Tensor, req_len: int):
    spectra = count_spectra(params, base_codes)
    twisted = project(params, spectra)
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
