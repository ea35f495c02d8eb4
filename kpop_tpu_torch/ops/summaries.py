"""The relatedness engine of the PyTorch port: the counterpart of
``kpop_tpu/ops/summaries.py``.

``kpop-twistdb -s`` summarizes 10^5-10^6 query rows against 10^3+ targets.
Each batch of queries is compared with every target on the device
(:func:`query_distances`) and digested there (:func:`digest_batch`: mean,
n-1 std, upper median, MAD and the top-(K + slack) nearest).  Only the
digests are downloaded; the host orders ties by (distance, target index),
falls back to a float64 row where a tie group overflows the slack, and
formats the lines (lib/Matrix.ml:632-690).  ``kpop-twistdb -d`` and
``kpop-countdb --distances`` download whole distance blocks instead
(:func:`distance_rowwise_device`).

Routes, picked by ``backend`` as the JAX package picks them: ``"pallas"``
computes euclidean blocks with the distance tile (``ops/pairwise.py``,
``csrc/pairwise.cu`` on a card); every other backend, and cosine and
minkowski under ``"pallas"``, takes the matmul expansion (what the JAX
package leaves to XLA) or the blocked minkowski broadcast, in plain torch.
On a CUDA tensor the digest launches ``csrc/digest.cu``; on a CPU tensor
it runs :func:`digest_batch_ref`.
"""

from __future__ import annotations

from collections import deque
from typing import IO

import numpy as np
import torch

from .. import native
from ..core.matrix import NamedMatrix
from ..core.space import Distance, summarize_distance_row
from ..utils.progress import Progress

from .. import _build
from ..config import device
from .pairwise import distance_tile, row_norms

TOPK_SLACK = 14
#: f32 elements budgeted for the blocked minkowski |b - a| broadcast
MINK_BUDGET_ELEMS = 32 << 20  # 128 MB
#: threads of a digest block (csrc/digest.cu); a row index stays below
#: N + DIGEST_THREADS
DIGEST_THREADS = 512
_INT_MAX = 2**31 - 1


def _native_formatter() -> bool:
    """True when the C summary-line formatter is built."""
    return native.available() and hasattr(native.get_lib(), "kpop_format_summary")


def query_norms(x: torch.Tensor, m: torch.Tensor, kind: str, power: float) -> torch.Tensor:
    """Row norms under the distance's own scaling (lib/Space.ml:159-181):
    euclidean sqrt(.), cosine (.)/2, minkowski (.)^(1/p); 0 -> 1."""
    if kind == "euclidean":
        return row_norms(x, m)
    if kind == "cosine":
        n = (x * x * m[None, :]).sum(dim=1) / 2.0
    else:
        n = (x.abs() ** power * m[None, :]).sum(dim=1) ** (1.0 / power)
    return torch.where(n == 0.0, torch.ones_like(n), n)


def distance_block(
    b: torch.Tensor,
    a: torch.Tensor,
    m: torch.Tensor,
    nb: torch.Tensor,
    na: torch.Tensor,
    kind: str,
    power: float,
    route: str,
) -> torch.Tensor:
    """``[B, N]`` distances of the queries ``b [B, D]`` scaled by ``1/nb``
    against the targets ``a [N, D]`` scaled by ``1/na``
    (``_distance_block``).  ``route="pallas"`` sends euclidean blocks to the
    distance tile, which scales the rows itself."""
    if kind == "euclidean" and route == "pallas":
        return distance_tile(b, a, m, nb, na)
    b = b / nb[:, None]
    a = a / na[:, None]
    if kind in ("euclidean", "cosine"):
        am = a * m[None, :]
        cross = b @ am.T
        na2 = (am * a).sum(dim=1)
        nb2 = (b * b * m[None, :]).sum(dim=1)
        acc = torch.clamp(nb2[:, None] + na2[None, :] - 2.0 * cross, min=0.0)
        return torch.sqrt(acc) if kind == "euclidean" else acc / 2.0
    # minkowski has no matmul expansion; the [B, chunk, D] broadcast is
    # blocked over the targets to bound its temporaries at about
    # MINK_BUDGET_ELEMS f32 (the host path blocks the same way)
    B, D = b.shape
    N = a.shape[0]
    chunk = int(max(1, min(N, MINK_BUDGET_ELEMS // max(1, B * D))))
    blocks = [
        ((b[:, None, :] - a[None, lo : lo + chunk, :]).abs() ** power * m[None, None, :]).sum(dim=2)
        for lo in range(0, N, chunk)
    ]
    return torch.cat(blocks, dim=1) ** (1.0 / power)


def query_distances(
    a: torch.Tensor,
    b: torch.Tensor,
    m: torch.Tensor,
    na: torch.Tensor,
    kind: str,
    power: float,
    normalize: bool,
    route: str,
) -> torch.Tensor:
    """``[B, N]`` distances of the query rows ``b`` against the targets
    ``a`` with their norms ``na`` (ones when not ``normalize``), each query
    first normalized when ``normalize`` (``_distance_rowwise_block``)."""
    if normalize:
        nb = query_norms(b, m, kind, power)
    else:
        nb = torch.ones(b.shape[0], dtype=b.dtype, device=b.device)
    return distance_block(b, a, m, nb, na, kind, power, route)


def digest_batch_ref(dmat: torch.Tensor, k: int):
    """Plain PyTorch version of :func:`digest_batch`: the digest of
    ``_digest_batch`` (``kpop_tpu/ops/summaries.py:120-141``).  The k
    smallest come from the stable sort that the median needs, so ties are
    taken lowest column first, as the kernel takes them (``torch.topk``
    leaves their order unspecified)."""
    N = dmat.shape[1]
    dmat = dmat + 0.0  # -0.0 -> +0.0, as the kernel returns zeros
    mean = dmat.mean(dim=1)
    std = torch.sqrt(((dmat - mean[:, None]) ** 2).sum(dim=1) / max(N - 1, 1))
    srt, order = torch.sort(dmat, dim=1, stable=True)
    h = N // 2
    median = srt[:, h]
    # the MAD without a second sort: |d - median| over the ascending row is
    # the merge of two sorted runs, so its upper median is the smallest
    # half-width whose window of srt around index h holds h + 1 elements
    W = min(h, N - 1 - h) + 1
    lo_diff = median[:, None] - srt[:, :W]
    hi_diff = srt[:, h : h + W] - median[:, None]
    mad = torch.maximum(lo_diff, hi_diff).min(dim=1).values
    stats = torch.stack([mean, std, median, mad], dim=1)
    return stats, srt[:, :k], order[:, :k]


def digest_batch(dmat: torch.Tensor, k: int):
    """Digest of each row of a distance block ``dmat [B, N]``:
    ``stats [B, 4]`` (mean, n-1 std, upper median, MAD) and the ``k``
    smallest entries, ``top [B, k]`` with their columns ``idx [B, k]``
    (int64), in (value, column) order; zeros come out as +0.0.  On a CUDA
    tensor it launches ``csrc/digest.cu``, then sorts the ``[B, k]`` list
    by value (``torch.sort``, stable); on a CPU tensor it runs
    :func:`digest_batch_ref`."""
    if dmat.dim() != 2:
        raise ValueError(f"digest_batch: dmat of shape {tuple(dmat.shape)}")
    B, N = dmat.shape
    if not 1 <= k <= N:
        raise ValueError(f"digest_batch: k={k} for rows of {N}")
    if dmat.device.type == "cpu":
        return digest_batch_ref(dmat, k)
    _build.check_cuda("digest_batch", dmat, dtypes=(torch.float32,))
    if B > _INT_MAX or N > _INT_MAX - DIGEST_THREADS:
        raise ValueError(f"digest_batch: B={B}, N={N} exceed the kernel's int range")
    stats = torch.empty((B, 4), dtype=torch.float32, device=dmat.device)
    top = torch.empty((B, k), dtype=torch.float32, device=dmat.device)
    idx = torch.empty((B, k), dtype=torch.int32, device=dmat.device)
    _build.launch(
        "kpop_row_digest",
        dmat.data_ptr(), B, N, k, stats.data_ptr(), top.data_ptr(), idx.data_ptr(),
    )
    # the kernel lists the entries below the k-th value, then its ties, each
    # group in column order: a stable sort by value gives (value, column)
    top, order = torch.sort(top, dim=1, stable=True)
    return stats, top, idx.gather(1, order).long()


def _to_device(x: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A C-ordered float32 copy of host rows on ``dev`` in a buffer of its
    own, uploaded without blocking.  The distance tile needs contiguous
    rows that start on 16 bytes: a row slice of an odd-width matrix does
    not, and ``kpop-countdb``'s spectra arrive transposed (Fortran order)."""
    t = torch.from_numpy(np.array(x, dtype=np.float32, order="C"))
    if dev.type == "cpu":
        return t
    return t.pin_memory().to(dev, non_blocking=True)


def _to_host(*tensors: torch.Tensor):
    """Start copying device results into pinned host memory.  Returns the
    host tensors and an event recorded behind the copies (None on the CPU):
    waiting on it, and not on the whole stream, lets the next batch run."""
    if tensors[0].device.type == "cpu":
        return tensors, None
    hosts = []
    for t in tensors:
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t, non_blocking=True)
        hosts.append(h)
    done = torch.cuda.Event()
    done.record()
    return hosts, done


def _wait(handle) -> list[np.ndarray]:
    hosts, done = handle
    if done is not None:
        done.synchronize()
    return [h.numpy() for h in hosts]


def _target_norms(distance: Distance, metric: np.ndarray, targets: np.ndarray, normalize: bool):
    """Host float64 target norms (0 -> 1), or ones without ``normalize``."""
    if not normalize:
        return np.ones(targets.shape[0])
    tn = distance.compute_norm(metric, targets)
    return np.where(tn == 0.0, 1.0, tn)


def summarize_rowwise_device(
    distance: Distance,
    metric: np.ndarray,
    m1: NamedMatrix,
    m2: NamedMatrix,
    keep_at_most: int | None,
    normalize: bool,
    out: IO[str],
    batch: int = 1024,
    backend: str = "jax",
) -> int:
    """Write summary lines for every m2 row against all m1 rows; returns
    the number of rows.

    The lines have the layout, names, nearest-target sets and tie order of
    :func:`kpop_tpu.core.space.summarize_rowwise`; the numbers carry the
    device's float32 error (<= ~2e-4 relative).  Rows whose tie group
    overflows the top-K slack fall back to the host float64 row.  One batch
    is in flight: the upload and digest of batch i+1 overlap the download
    and formatting of batch i.  ``backend="pallas"`` computes euclidean
    blocks with the distance tile; other distances take the matmul route.
    """
    route = "pallas" if backend == "pallas" else "jax"
    dev = device()
    targets = np.asarray(m1.data, dtype=np.float64)
    N = targets.shape[0]
    req_len = N if keep_at_most is None else keep_at_most
    k_cap = min(N, req_len + TOPK_SLACK)
    tn = _target_norms(distance, metric, targets, normalize)
    td, md, tnd = (_to_device(x, dev) for x in (targets, metric, tn))
    queries = np.asarray(m2.data, dtype=np.float64)
    col_names = m1.row_names
    n_rows = 0
    host_fallbacks = 0
    prog = Progress(
        "Matrix.summarize_rowwise", "Summarizing distances (device)",
        queries.shape[0],
    )
    pending: deque = deque()

    def _dispatch(lo: int):
        q = _to_device(queries[lo : lo + batch], dev)
        dmat = query_distances(
            td, q, md, tnd, distance.kind, distance.power, normalize, route
        )
        return lo, q.shape[0], _to_host(*digest_batch(dmat, k_cap))

    use_native_fmt = _native_formatter()
    if use_native_fmt:
        col_blob, col_offs, col_lens = native._names_blob(col_names)

    def _fallback_line(j_abs: int) -> str:
        row = _host_row(distance, metric, targets, tn, queries[j_abs], normalize)
        return (
            summarize_distance_row(req_len, m2.row_names[j_abs], row, col_names)
            + "\n"
        )

    def _drain_one():
        nonlocal n_rows, host_fallbacks
        lo, B, handle = pending.popleft()
        prog.update(lo)
        # digest_batch lists each row's k smallest in (distance, target
        # index) order, the order of the lines
        stats, top, idx = [np.asarray(x, dtype=np.float64) for x in _wait(handle)]
        # eff_len per row: whole tie groups until >= req_len (top is
        # ascending, so the selected entries are a prefix)
        kth_val = top[:, min(req_len, k_cap) - 1]
        eff = (top <= kth_val[:, None]).sum(axis=1)
        # tie groups that may extend beyond the device top-K: exact host row
        fallback = (eff >= k_cap) & (k_cap < N)
        if use_native_fmt:
            eff_n = np.where(fallback, -1, eff).astype(np.int64)
            blob = native.format_summary(
                m2.row_names[lo : lo + B], stats, top, idx, eff_n,
                col_blob, col_offs, col_lens,
            ).decode("utf-8")
            if fallback.any():
                # interleave exact host lines at their row positions.
                # Split on '\n' ONLY (the C formatter's one-\n-per-row
                # contract): str.splitlines also splits on \v, \f, \x85,
                # U+2028... inside names, which would misalign rows
                lines = [s + "\n" for s in blob.split("\n")[:-1]]
                merged, li = [], 0
                for j in range(B):
                    if fallback[j]:
                        merged.append(_fallback_line(lo + j))
                    else:
                        merged.append(lines[li])
                        li += 1
                blob = "".join(merged)
            out.write(blob)
            host_fallbacks += int(fallback.sum())
            n_rows += B - int(fallback.sum())
            return
        mean, std = stats[:, 0], stats[:, 1]
        for j in range(B):
            if fallback[j]:
                host_fallbacks += 1
                out.write(_fallback_line(lo + j))
                continue
            parts = [m2.row_names[lo + j]]
            parts += ["%.15g" % v for v in stats[j]]
            with np.errstate(divide="ignore", invalid="ignore"):
                for s in range(int(eff[j])):
                    d = top[j, s]
                    z = (d - mean[j]) / std[j]
                    parts += [col_names[int(idx[j, s])], "%.15g" % d, "%.15g" % z]
            out.write("\t".join(parts) + "\n")
            n_rows += 1

    for lo in range(0, queries.shape[0], batch):
        pending.append(_dispatch(lo))
        if len(pending) >= 2:
            _drain_one()
    while pending:
        _drain_one()
    prog.done("queries.")
    return n_rows + host_fallbacks


def _host_row(distance, metric, targets, tnorms, query, normalize):
    """One query's float64 distance row on the host (the tie fallback)."""
    q = query
    if normalize:
        nq = float(distance.compute_norm(metric, q))
        nq = 1.0 if nq == 0.0 else nq
        q = q / nq
    a = targets / tnorms[:, None]
    if distance.kind in ("euclidean", "cosine"):
        d2 = ((a - q[None, :]) ** 2 * metric[None, :]).sum(axis=1)
        return np.sqrt(d2) if distance.kind == "euclidean" else d2 / 2.0
    return (
        (np.abs(a - q[None, :]) ** distance.power * metric[None, :]).sum(axis=1)
    ) ** (1.0 / distance.power)


def distance_rowwise_device(
    distance: Distance,
    metric: np.ndarray,
    m1: NamedMatrix,
    m2: NamedMatrix,
    normalize: bool = True,
    backend: str = "jax",
    batch: int = 4096,
) -> NamedMatrix:
    """Full rectangular distance matrix on the device (rows = m2's rows,
    cols = m1's rows, the ``get_distance_rowwise`` orientation,
    lib/Matrix.ml:191-266), blocked over the query rows and downloaded
    into float64.  ``backend="pallas"`` computes euclidean blocks with the
    distance tile; others take the matmul route (float32 on the device; the
    float64 host path in ``kpop_tpu.core.space`` stays the reference)."""
    route = "pallas" if backend == "pallas" else "jax"
    dev = device()
    targets = np.asarray(m1.data, dtype=np.float64)
    queries = np.asarray(m2.data, dtype=np.float64)
    tn = _target_norms(distance, metric, targets, normalize)
    td, md, tnd = (_to_device(x, dev) for x in (targets, metric, tn))
    out = np.zeros((queries.shape[0], targets.shape[0]))
    for lo in range(0, queries.shape[0], batch):
        q = _to_device(queries[lo : lo + batch], dev)
        block = query_distances(
            td, q, md, tnd, distance.kind, distance.power, normalize, route
        )
        out[lo : lo + batch] = block.cpu().numpy()
    return NamedMatrix(list(m2.row_names), list(m1.row_names), out)
