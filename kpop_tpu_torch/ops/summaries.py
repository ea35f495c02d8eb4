"""The relatedness engine of the PyTorch port: the counterpart of
``kpop_tpu/ops/summaries.py``.

``kpop-twistdb -s`` summarizes 10^5-10^6 query rows against 10^3+ targets
through a :class:`SummaryStep`, built once per target database.  Each
batch of queries is compared with every target on the device
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

from typing import IO

import numpy as np
import torch

from .. import native, trace
from ..core.matrix import NamedMatrix
from ..core.space import Distance, summarize_distance_row
from ..utils.progress import Progress

from .. import _build
from ..config import device
from .pairwise import distance_tile, row_norms

TOPK_SLACK = 14
#: f32 elements budgeted for the blocked minkowski |b - a| broadcast
MINK_BUDGET_ELEMS = 32 << 20  # 128 MB
#: threads of a digest block (csrc/digest.cu) at most; a row index stays
#: below N + DIGEST_THREADS
DIGEST_THREADS = 512
#: the digest kernel orders the k smallest by (value, column) itself for k
#: up to this; a larger k is sorted by the wrapper
DIGEST_K_MAX = 32
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
    tensor it launches ``csrc/digest.cu``, which orders the k smallest
    itself for ``k <= DIGEST_K_MAX``; a larger k comes back as the entries
    below the k-th value, then its ties, each group by column, and a stable
    ``torch.sort`` by value orders it.  On a CPU tensor it runs
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
    idx = torch.empty((B, k), dtype=torch.int64, device=dmat.device)
    _build.launch(
        "kpop_row_digest",
        dmat.data_ptr(), B, N, k, stats.data_ptr(), top.data_ptr(), idx.data_ptr(),
    )
    if k > DIGEST_K_MAX:
        top, order = torch.sort(top, dim=1, stable=True)
        idx = idx.gather(1, order)
    return stats, top, idx


def _to_device(x: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A C-ordered float32 copy of host rows on ``dev`` in a buffer of its
    own, uploaded without blocking.  The distance tile needs contiguous
    rows that start on 16 bytes: a row slice of an odd-width matrix does
    not, and ``kpop-countdb``'s spectra arrive transposed (Fortran order)."""
    t = torch.from_numpy(np.array(x, dtype=np.float32, order="C"))
    if dev.type == "cpu":
        return t
    return t.pin_memory().to(dev, non_blocking=True)


def _target_norms(distance: Distance, metric: np.ndarray, targets: np.ndarray, normalize: bool):
    """Host float64 target norms (0 -> 1), or ones without ``normalize``."""
    if not normalize:
        return np.ones(targets.shape[0])
    tn = distance.compute_norm(metric, targets)
    return np.where(tn == 0.0, 1.0, tn)


class _Slot:
    """One batch's reused buffers: the f32 queries on the host (pinned on a
    card) and on the device, the digests' host buffers, the event recorded
    behind the batch's downloads, and the batch that holds the slot until
    it is materialized."""

    __slots__ = ("host", "rows", "device", "digests", "done", "batch")

    def __init__(self, batch: int, d: int, k: int, dev: torch.device):
        pinned = dev.type != "cpu"
        self.host = torch.empty((batch, d), dtype=torch.float32, pin_memory=pinned)
        self.rows = self.host.numpy()
        self.device = torch.empty((batch, d), dtype=torch.float32, device=dev)
        self.digests = [torch.empty(shape, dtype=dt, pin_memory=pinned) for shape, dt in (
            ((batch, 4), torch.float32), ((batch, k), torch.float32), ((batch, k), torch.int64))]
        self.done: torch.cuda.Event | None = None
        self.batch = None


class SummaryStep:
    """The relatedness engine of ``kpop-twistdb -s`` as a step built once
    per target database: :meth:`dispatch` a block of query rows, then
    :meth:`materialize` its summary lines.

    Built once: the host float64 target norms, the targets, metric and
    norms on the device, the digest's width (``k_cap``: the lines' length
    plus :data:`TOPK_SLACK`), the names blob of the C formatter, and
    :attr:`SLOTS` slots of reused buffers (:class:`_Slot`).  A batch takes
    the next slot: its float64 rows are cast straight into the slot's
    pinned buffer, uploaded without blocking, compared with every target
    (:func:`query_distances`) and digested (:func:`digest_batch`) on the
    device, and the digests' download is started with an event recorded
    behind it.  A slot is taken again only once its batch was materialized
    and its event has completed, so at most :attr:`SLOTS` batches are in
    flight.  On the CPU the same code runs on host tensors.

    :meth:`materialize` waits on the batch's event alone and formats its
    lines (lib/Matrix.ml:632-690) with the C formatter where it is built:
    whole tie groups up to the lines' length, in (distance, target index)
    order, and the host float64 row where a tie group may reach past the
    digest's width."""

    SLOTS = 2

    def __init__(
        self,
        distance: Distance,
        metric: np.ndarray,
        targets: NamedMatrix,
        keep_at_most: int | None,
        normalize: bool,
        backend: str = "jax",
        batch: int = 1024,
    ):
        self.route = "pallas" if backend == "pallas" else "jax"
        self.dev = device()
        self.distance, self.normalize, self.batch = distance, normalize, batch
        self.metric = np.asarray(metric, dtype=np.float64)
        self.targets = np.asarray(targets.data, dtype=np.float64)
        N, d = self.targets.shape
        self.n_targets = N
        self.req_len = N if keep_at_most is None else keep_at_most
        self.k_cap = min(N, self.req_len + TOPK_SLACK)
        self.tn = _target_norms(distance, self.metric, self.targets, normalize)
        self._td, self._md, self._tnd = (
            _to_device(x, self.dev) for x in (self.targets, self.metric, self.tn))
        self.col_names = targets.row_names
        self._names = native._names_blob(self.col_names) if _native_formatter() else None
        self._slots = [_Slot(batch, d, self.k_cap, self.dev) for _ in range(self.SLOTS)]
        self._turn = 0

    def dispatch(self, rows: np.ndarray, names):
        """Start a batch: the float64 query rows ``rows [B, d]`` (B at most
        the step's batch) and their names.  Returns the batch's handle."""
        rows = np.asarray(rows, dtype=np.float64)
        B = rows.shape[0]
        if not 0 < B <= self.batch or len(names) != B:
            raise ValueError(f"SummaryStep.dispatch: {B} rows and {len(names)} names "
                             f"for a batch of at most {self.batch}")
        on_card = self.dev.type != "cpu"
        with trace.span("relate.dispatch"):
            slot = self._slots[self._turn]
            if slot.batch is not None:
                raise RuntimeError(f"SummaryStep: more than {self.SLOTS} batches in flight")
            self._turn = (self._turn + 1) % self.SLOTS
            with trace.span("relate.stage"):
                if slot.done is not None:
                    slot.done.synchronize()
                np.copyto(slot.rows[:B], rows)
            with trace.span("relate.upload"):
                q = slot.device[:B]
                q.copy_(slot.host[:B], non_blocking=True)
            with trace.span("relate.launch"):
                dmat = query_distances(self._td, q, self._md, self._tnd, self.distance.kind,
                                       self.distance.power, self.normalize, self.route)
                digests = digest_batch(dmat, self.k_cap)
            with trace.span("relate.download"):
                for host, t in zip(slot.digests, digests):
                    host[:B].copy_(t, non_blocking=True)
                if on_card:
                    slot.done = torch.cuda.Event()
                    slot.done.record()
            trace.count("relate.batches")
            trace.count("relate.queries", B)
            trace.count("relate.upload_bytes", q.nbytes)
            slot.batch = (rows, list(names))
            return slot, slot.batch

    def materialize(self, handle) -> str:
        """The summary lines of the batch ``handle``, one ``\\n``-ended line
        a row, once its digests are on the host."""
        slot, batch = handle
        if slot.batch is not batch:
            raise ValueError("SummaryStep.materialize: the batch was materialized already")
        rows, names = batch
        B = len(names)
        with trace.span("relate.wait"):
            if slot.done is not None:
                slot.done.synchronize()
            # digest_batch lists each row's k smallest in (distance, target
            # index) order, the order of the lines
            stats, top = (h[:B].numpy().astype(np.float64) for h in slot.digests[:2])
            idx = slot.digests[2][:B].numpy().copy()
            slot.batch = None
        with trace.span("relate.format"):
            # eff per row: whole tie groups until >= req_len (top is
            # ascending, so the selected entries are a prefix)
            kth_val = top[:, min(self.req_len, self.k_cap) - 1]
            eff = (top <= kth_val[:, None]).sum(axis=1)
            # tie groups that may extend beyond the device top-K: exact host row
            fallback = (eff >= self.k_cap) & (self.k_cap < self.n_targets)
            trace.count("relate.fallback_rows", int(fallback.sum()))
            if self._names is not None:
                return self._format_native(names, rows, stats, top, idx, eff, fallback)
            return "".join(
                self._fallback_line(rows[j], names[j]) if fallback[j]
                else self._format_row(names[j], stats[j], top[j], idx[j], int(eff[j]))
                for j in range(B))

    def _format_native(self, names, rows, stats, top, idx, eff, fallback) -> str:
        eff_n = np.where(fallback, -1, eff).astype(np.int64)
        blob = native.format_summary(names, stats, top, idx, eff_n, *self._names).decode("utf-8")
        if not fallback.any():
            return blob
        # interleave exact host lines at their row positions.  Split on '\n'
        # ONLY (the C formatter's one-\n-per-row contract): str.splitlines
        # also splits on \v, \f, \x85, U+2028... inside names, which would
        # misalign rows
        lines = iter(blob.split("\n")[:-1])
        return "".join(self._fallback_line(rows[j], names[j]) if fallback[j]
                       else next(lines) + "\n" for j in range(len(names)))

    def _format_row(self, name: str, stats, top, idx, eff: int) -> str:
        parts = [name] + ["%.15g" % v for v in stats]
        with np.errstate(divide="ignore", invalid="ignore"):
            for s in range(eff):
                d = top[s]
                z = (d - stats[0]) / stats[1]
                parts += [self.col_names[int(idx[s])], "%.15g" % d, "%.15g" % z]
        return "\t".join(parts) + "\n"

    def _fallback_line(self, query: np.ndarray, name: str) -> str:
        row = _host_row(self.distance, self.metric, self.targets, self.tn, query, self.normalize)
        return summarize_distance_row(self.req_len, name, row, self.col_names) + "\n"


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
    overflows the top-K slack fall back to the host float64 row.  A loop
    over one :class:`SummaryStep` with one batch in flight: the upload and
    digest of batch i+1 overlap the download and formatting of batch i.
    ``backend="pallas"`` computes euclidean blocks with the distance tile;
    other distances take the matmul route.
    """
    queries = np.asarray(m2.data, dtype=np.float64)
    n = queries.shape[0]
    step = SummaryStep(distance, metric, m1, keep_at_most, normalize, backend,
                       batch=max(1, min(batch, n)))
    prog = Progress(
        "Matrix.summarize_rowwise", "Summarizing distances (device)", n,
    )
    pending = None
    for lo in range(0, n, batch):
        handle = step.dispatch(queries[lo : lo + batch], m2.row_names[lo : lo + batch])
        if pending is not None:
            prog.update(pending[0])
            out.write(step.materialize(pending[1]))
        pending = lo, handle
    if pending is not None:
        prog.update(pending[0])
        out.write(step.materialize(pending[1]))
    prog.done("queries.")
    return n


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
