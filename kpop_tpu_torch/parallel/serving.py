"""K-mer-sharded serving: the counterpart of
``kpop_tpu/parallel/serving.py``.

The reference's flagship classifiers have twisters that one card cannot
hold: the SARS-CoV-2 lineage classifier's ~10^6 k-mers x 1,635 dims
(6.5 GB in f32, the reference README.md:1023-1054), and TB at k = 12, up
to 4^12 = 16.7M rows (README.md:530).  Each rank of the layout's
``"kmer"`` axis holds rows ``[j V_local, (j + 1) V_local)`` of the twister,
zero-padded to a multiple of ``kp`` rows; the vocabulary's tables (the
dense LUT, or the cuckoo hash or sorted limbs), the metric and the class
coordinates are replicated.  A bf16 shard keeps :func:`~..ops.pipeline.
bf16_rows`' 16-byte-aligned rows.

A batch, on each rank of a data group:

1. ``csrc/count_spectra.cu`` counts the rank's row range into a
   ``[B, V_local]`` f32 spectrum, and each read set's known windows, all of
   them (:func:`~..ops.pipeline.count_spectra` with ``row0, rows,
   known``);
2. the product with the local rows (``torch.matmul``, or
   :func:`~..ops.pipeline.bf16_product` with an f32 output on bf16 shards);
3. the ``[B, d]`` partial divided by the global known-window count (0
   becomes 1): the lookup tables are replicated, so each shard has it;
4. one ``all_reduce(SUM)`` of ``[B, d]`` f32 over the kmer group: the
   payload is independent of V;
5. :func:`~..ops.pipeline.distances_to_classes` (``csrc/pairwise.cu``),
   redundantly on every rank of the group.

As in the JAX tool, the sharded path never takes the embedding bag.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.pipeline import (
    PARAM_ARRAYS,
    ClassifierParams,
    assemble_params,
    bf16_product,
    bf16_rows,
    count_spectra,
    distances_to_classes,
    normalized,
    serving_vocab,
)
from .mesh import Layout, all_reduce, broadcast_host, split_rows

#: the arrays of a ClassifierParams replicated on every rank: all but the
#: twister
REPLICATED = tuple(f for f in PARAM_ARRAYS if f != "twister")


def _shard(params: ClassifierParams, rows: torch.Tensor, row0: int, V_local: int,
           device) -> ClassifierParams:
    """``params`` on ``device`` with the twister rows ``rows`` (starting at
    vocabulary row ``row0``), zero-padded to ``V_local``, in place of the
    whole twister."""
    device = torch.device(device) if device is not None else params.twister.device
    n, d = rows.shape
    buf = rows
    if n < V_local:
        buf = torch.zeros((V_local, d), dtype=rows.dtype, device=rows.device)
        buf[:n] = rows
    tw = bf16_rows(buf, device) if buf.dtype == torch.bfloat16 else buf.to(device)
    return ClassifierParams(
        twister=tw,
        **{f: None if getattr(params, f) is None else getattr(params, f).to(device)
           for f in REPLICATED},
        k=params.k, canonical=params.canonical, base=params.base,
        distance_kind=params.distance_kind, cuckoo_seeds=params.cuckoo_seeds,
        vocab_size=params.n_vocab, row0=row0,
    )


def shard_classifier_params(params: ClassifierParams, mesh: Layout,
                            device=None) -> tuple[ClassifierParams, int]:
    """This rank's serving parameters: the twister rows of its kmer index,
    zero-padded so that V divides the kmer axis (zero rows add nothing to
    the product), and every other tensor replicated, all on ``device``
    (the twister's by default).  ``params`` holds the whole twister, on the
    host (``build_classifier_params(..., device="cpu")``) or a card; only
    the shard crosses to ``device``.  Returns the parameters and the
    global (unpadded) vocabulary size."""
    V = params.n_vocab
    if params.twister.shape[0] != V:
        raise ValueError("shard_classifier_params: the parameters hold a shard already")
    V_local = -(-V // mesh.kp)
    lo, hi = split_rows(V, mesh.kp, mesh.kmer_index)
    return _shard(params, params.twister[lo:hi], mesh.kmer_index * V_local, V_local, device), V


def params_around_sharded_twister(space, kmer_names: list[str], twister, inertia, class_coords,
                                  mesh: Layout, distance=None, metric=None,
                                  dtype: torch.dtype = torch.float32
                                  ) -> tuple[ClassifierParams, int]:
    """The train-to-serve handoff of a rank-sharded fit: ``twister`` is the
    :class:`~.mesh.ShardedRows` that ``ca_fit_sharded(..., phi="device",
    mesh=mesh)`` returns, this rank's rows of the ``[V, d]`` f32 twister in
    the table's order, split over all ``dp kp`` ranks.  Serving splits the
    rows over ``kp`` in the vocabulary's order (the sorted k-mer codes above
    the dense-LUT limit), so each rank gathers the rows of its serving
    shard: its own from its card, each other rank's from a broadcast of
    that rank's rows through the host, made only where another rank needs
    them (none with the dense LUT and ``dp = 1``, where the two layouts
    coincide).  Returns the parameters on the twister's device and the
    global vocabulary size."""
    vocab, order = serving_vocab(space, kmer_names)
    V = len(kmer_names)
    if twister.total != V or twister.rows != mesh.rows(V):
        raise ValueError(f"rows {twister.rows} of {twister.total}: not this rank's rows of the "
                         f"{V} k-mers' fit over the layout, {mesh.rows(V)}")
    order = np.arange(V) if order is None else np.asarray(order, dtype=np.int64)
    V_local = -(-V // mesh.kp)
    per = -(-V // mesh.world)  # the fit's rows a rank

    def wanted(r: int) -> np.ndarray:
        """Table rows of rank r's serving shard, in its order."""
        return order[slice(*split_rows(V, mesh.kp, r % mesh.kp))]

    src = wanted(mesh.rank)
    owner = src // per
    local = twister.local
    dev, d = local.device, local.shape[1]
    shard = torch.zeros((V_local, d), dtype=torch.float32, device=dev)  # zero past V
    mine = np.flatnonzero(owner == mesh.rank)
    if len(mine):
        at = torch.as_tensor(src[mine] - twister.row0, device=dev)
        shard[torch.as_tensor(mine, device=dev)] = local.index_select(0, at).float()
    owners = [wanted(r) // per for r in range(mesh.world)]
    for s in range(mesh.world):
        # every rank decides alike whether rank s's rows must travel
        if not any((owners[r] == s).any() for r in range(mesh.world) if r != s):
            continue
        lo, hi = split_rows(V, mesh.world, s)
        buf = broadcast_host(local if mesh.rank == s else None, s, mesh.world_host,
                             (hi - lo, d), local.dtype)
        take = np.flatnonzero(owner == s)
        if s != mesh.rank and len(take):
            rows = buf[torch.as_tensor(src[take] - lo)].float().to(dev)
            shard[torch.as_tensor(take, device=dev)] = rows
    base = assemble_params(space, vocab, shard[:0], inertia, class_coords, distance, metric,
                           dev, vocab_size=V)
    return _shard(base, shard if dtype == torch.float32 else shard.to(dtype),
                  mesh.kmer_index * V_local, V_local, dev), V


def count_shard(params: ClassifierParams, codes: torch.Tensor):
    """Step 1: the ``[B, V_local]`` f32 spectrum of the rank's rows and
    each read set's count of its known windows (``[B]`` int32)."""
    return count_spectra(params, codes, row0=params.row0, rows=params.twister.shape[0],
                         known=True)


def project_shard(params: ClassifierParams, spectra: torch.Tensor, known: torch.Tensor,
                  normalize: bool = True) -> torch.Tensor:
    """Steps 2 and 3: the ``[B, d]`` f32 product with the local rows,
    divided once by the global known-window count (0 becomes 1,
    :func:`~..ops.pipeline.normalized`)."""
    if params.twister.dtype == torch.bfloat16:
        part = bf16_product(spectra.to(torch.bfloat16), params.twister)
    else:
        part = spectra @ params.twister
    return normalized(part, known) if normalize else part


def sharded_dmat_fn(mesh: Layout, n_vocab: int, normalize: bool = True):
    """``(sharded_params, codes) -> [B, C]`` distances of this rank's data
    group's ``[B, L]`` int8 codes on the rank's device (pad a batch with
    all ``-1`` rows: they produce empty spectra)."""

    def fn(params: ClassifierParams, codes: torch.Tensor) -> torch.Tensor:
        if params.n_vocab != n_vocab:
            raise ValueError(f"parameters of a vocabulary of {params.n_vocab}, not {n_vocab}")
        spectra, known = count_shard(params, codes)
        twisted = all_reduce(project_shard(params, spectra, known, normalize), mesh.kmer_group)
        return distances_to_classes(params, twisted, normalize=normalize)

    return fn


def choose_kmer_parallel(twister_bytes: int, n_devices: int, budget_bytes: int) -> int:
    """Smallest divisor of ``n_devices`` whose twister shard fits the
    per-device parameter budget (falls back to fully kmer-sharded when even
    that exceeds it — the least-bad layout)."""
    best = n_devices
    for kp in sorted(d for d in range(1, n_devices + 1) if n_devices % d == 0):
        if twister_bytes / kp <= budget_bytes:
            best = kp
            break
    return best
