"""The fused serving pipeline: the counterpart of
``kpop_tpu/ops/pipeline.py``.

    base codes -> window codes -> vocabulary LUT -> [B, V] spectrum
      -> [B, V] x [V, d] twister product -> distances to the C classes
      -> mean, std, upper median, MAD and top-k

or, in place of the spectrum and the product, the embedding bag
(:func:`project_reads`).  The public functions keep the JAX package's names
and layouts: ``[B, L]`` int8 base codes, a ``[V, d]`` twister, ``[B, C]``
distances.

Three steps are CUDA kernels on a card: counting (``csrc/count_spectra.cu``,
window codes + LUT + scatter in one pass), the embedding bag
(``csrc/embedding_bag.cu``) and the euclidean distance tile
(``csrc/pairwise.cu`` through :mod:`.pairwise`).  Each wrapper runs its
plain PyTorch version (``*_ref``) for tensors on the CPU and launches its
kernel, or raises, for tensors on a card.  The twister product is a plain
f32 ``torch.matmul``, as the JAX package left it to XLA.

Not ported yet (they raise): k above :func:`~.encode.lut_k_max` (the
two-limb cuckoo lookup) and bf16 twisters.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..core.kmers import KmerSpace
from ..core.space import Distance, Metric, normalizations
from ..core.twister import Twister

from .. import _build
from .encode import lut_k_max, window_codes_batch
from .pairwise import distance_tile, row_norms

ROADMAP_NOTE = "not ported to kpop_tpu_torch yet (ROADMAP.md, queue 1)"


class ClassifierParams(nn.Module):
    """Device-resident parameters of the count + twist + classify model.

    Buffers: ``vocab_lut [base^k + 1]`` int32 (code -> twister row, V for a
    k-mer outside the vocabulary), ``twister [V, d]`` f32, ``metric [d]``,
    ``class_coords [C, d]`` and ``class_norms [C]``.
    """

    def __init__(
        self,
        vocab_lut: torch.Tensor,
        twister: torch.Tensor,
        metric: torch.Tensor,
        class_coords: torch.Tensor,
        class_norms: torch.Tensor,
        k: int,
        canonical: bool,
        base: int = 4,
        distance_kind: str = "euclidean",
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
        if k > lut_k_max(base):
            raise NotImplementedError(
                f"k={k} is above the dense-LUT limit {lut_k_max(base)} for "
                f"base {base}: the large-k cuckoo lookup is {ROADMAP_NOTE}"
            )
        if vocab_lut.shape != (base**k + 1,) or vocab_lut.dtype != torch.int32:
            raise ValueError(
                f"vocab_lut must be int32 of shape ({base**k + 1},), got "
                f"{vocab_lut.dtype} {tuple(vocab_lut.shape)}"
            )
        self.register_buffer("vocab_lut", vocab_lut)
        self.register_buffer("twister", twister)
        self.register_buffer("metric", metric)
        self.register_buffer("class_coords", class_coords)
        self.register_buffer("class_norms", class_norms)
        self.k = k
        self.canonical = canonical
        self.base = base
        self.distance_kind = distance_kind

    @property
    def n_vocab(self) -> int:
        return self.twister.shape[0]


def build_classifier_params(
    space: KmerSpace,
    twister: Twister,
    class_coords: np.ndarray,
    distance: Distance | None = None,
    metric: Metric | None = None,
    device: torch.device | str | None = None,
) -> ClassifierParams:
    """Assemble device parameters from host artefacts (the dense-LUT branch
    of the JAX ``build_classifier_params``): the host ``[d, V]`` twister is
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
    trains (the train-to-serve handoff of ``bench.py``, without a download):
    the hex k-mer labels become a lookup table over the whole base^k code
    space, with unknown k-mers routed to V (dropped, lib/Twister.ml:
    167-169); the metric comes from the inertia (lib/Twister.ml:208-209)."""
    distance = distance or Distance.of_string("euclidean")
    metric = metric or Metric.of_string("powers(1,1,2)")
    if space.k > lut_k_max(space.base):
        raise NotImplementedError(
            f"k={space.k} is above the dense-LUT limit "
            f"{lut_k_max(space.base)}: the large-k cuckoo lookup is "
            f"{ROADMAP_NOTE}"
        )
    kmer_codes = np.array([space.hex_to_code(h) for h in kmer_names], dtype=np.int64)
    V = len(kmer_codes)
    lut = np.full(space.n_kmers + 1, V, dtype=np.int32)
    lut[kmer_codes] = np.arange(V, dtype=np.int32)
    mvec = metric.compute(np.asarray(inertia, dtype=np.float64))
    cls_norms = normalizations(distance, mvec, class_coords)
    device = twister.device

    def f32(x):  # C order: the kernels take contiguous tensors
        return torch.as_tensor(np.ascontiguousarray(x, dtype=np.float32), device=device)

    return ClassifierParams(
        vocab_lut=torch.as_tensor(lut, device=device),
        twister=twister,
        metric=f32(mvec),
        class_coords=f32(class_coords),
        class_norms=f32(cls_norms),
        k=space.k,
        canonical=space.canonical,
        base=space.base,
        distance_kind=distance.kind,
    )


def params_from_jax(
    arrays: dict[str, np.ndarray],
    k: int,
    canonical: bool,
    base: int,
    distance_kind: str,
    device: torch.device | str | None = None,
) -> ClassifierParams:
    """Carry the JAX package's ``ClassifierParams`` across: ``arrays`` holds
    its fields ``vocab_lut``, ``twister``, ``metric``, ``class_coords`` and
    ``class_norms`` as numpy arrays (``np.asarray(field)``)."""
    from ..config import device as default_device

    device = default_device() if device is None else torch.device(device)
    if arrays.get("vocab_lut") is None:
        raise NotImplementedError(
            f"parameters without a dense vocab_lut (large k) are {ROADMAP_NOTE}"
        )
    if np.asarray(arrays["twister"]).dtype != np.float32:
        raise NotImplementedError(
            f"{np.asarray(arrays['twister']).dtype} twisters are {ROADMAP_NOTE}"
        )

    def t(name):
        # a C-order copy: arrays taken from JAX are read-only
        return torch.tensor(np.ascontiguousarray(arrays[name]), device=device)

    return ClassifierParams(
        vocab_lut=t("vocab_lut"),
        twister=t("twister"),
        metric=t("metric"),
        class_coords=t("class_coords"),
        class_norms=t("class_norms"),
        k=k,
        canonical=canonical,
        base=base,
        distance_kind=distance_kind,
    )


def vocab_lookup(params: ClassifierParams, base_codes: torch.Tensor) -> torch.Tensor:
    """``[B, L]`` base codes -> vocabulary index ``[B, W]`` in [0..V], with
    V for a miss or an invalid window (plain PyTorch)."""
    codes, ok = window_codes_batch(
        base_codes, params.k, params.canonical, params.base
    )
    idx = params.vocab_lut[codes.long()]
    return torch.where(ok, idx, torch.full_like(idx, params.n_vocab))


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


def count_spectra(params: ClassifierParams, base_codes: torch.Tensor) -> torch.Tensor:
    """``[B, L]`` int8 base codes -> vocabulary-aligned spectra ``[B, V]``
    f32.  Counts are exact (integers below 2^24 per cell)."""
    B, L = _check_codes("count_spectra", params, base_codes)
    if base_codes.device.type == "cpu":
        return count_spectra_ref(params, base_codes)
    _build.check_cuda(
        "count_spectra", base_codes, params.vocab_lut,
        dtypes=(torch.int8, torch.int32),
    )
    if B > 65535:
        raise ValueError(f"count_spectra: batch {B} exceeds the kernel's grid")
    V = params.n_vocab
    out = torch.zeros((B, V), dtype=torch.float32, device=base_codes.device)
    _build.launch(
        "kpop_count_spectra",
        base_codes.data_ptr(), B, L, params.k, int(params.canonical),
        params.base, params.vocab_lut.data_ptr(), V, out.data_ptr(),
    )
    return out


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


def project_reads(
    params: ClassifierParams, base_codes: torch.Tensor, normalize: bool = True
) -> torch.Tensor:
    """Reads -> twisted coordinates ``[B, d]`` without spectra:
    ``twisted[b] = sum_w twister[lut[code_w]] / n_known`` (unknown k-mers
    drop out, duplicates accumulate; lib/Twister.ml:146-188)."""
    B, L = _check_codes("project_reads", params, base_codes)
    if base_codes.device.type == "cpu":
        return project_reads_ref(params, base_codes, normalize)
    _build.check_cuda(
        "project_reads", base_codes, params.vocab_lut, params.twister,
        dtypes=(torch.int8, torch.int32, torch.float32),
    )
    V, d = params.twister.shape
    out = torch.empty((B, d), dtype=torch.float32, device=base_codes.device)
    _build.launch(
        "kpop_embedding_bag",
        base_codes.data_ptr(), B, L, params.k, int(params.canonical),
        params.base, params.vocab_lut.data_ptr(), V,
        params.twister.data_ptr(), d, int(normalize), out.data_ptr(),
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
