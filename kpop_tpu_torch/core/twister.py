"""Twister objects: a coordinate transformation + per-dimension inertia.

Re-design of reference lib/Twister.ml and of the bash+R front end
``src/KPopTwist`` (training).  A twister pairs a ``[dims, n_kmers]`` matrix
with an inertia row vector; training runs the in-house CA (:mod:`.ca`)
directly on the in-memory counts DB — no table export, R subprocess or text
round-trip — and projection of new spectra is a batched dense matmul
(MXU-friendly) instead of a per-spectrum sparse matvec fork
(lib/Twister.ml:58-206).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..io import framed
from ..io import spectra as spectra_io
from ..utils.naming import (
    TWISTER_BIN_EXT,
    close_if_owned,
    open_in,
    open_in_bin,
    open_out_bin,
    with_ext,
)
from . import ca as ca_mod
from .counter_db import CounterDB, TableFilter
from .matrix import KPopMatrix, MatrixType, NamedMatrix
from .space import Metric
from .transforms import Transformation


class MismatchedTwisterFiles(ValueError):
    pass


class IncompatibleTwisterAndTwisted(ValueError):
    pass


class DuplicateLabel(ValueError):
    pass


@dataclass
class Twister:
    twister: KPopMatrix = field(
        default_factory=lambda: KPopMatrix(MatrixType.TWISTER)
    )
    inertia: KPopMatrix = field(
        default_factory=lambda: KPopMatrix(MatrixType.INERTIA)
    )

    def _check(self) -> None:
        """Consistency checks of lib/Twister.ml:36-50."""
        if self.inertia.matrix.row_names not in ([], ["inertia"]) or (
            self.twister.matrix.row_names != self.inertia.matrix.col_names
        ):
            raise MismatchedTwisterFiles(
                self.twister.matrix.row_names,
                self.inertia.matrix.col_names,
                self.inertia.matrix.row_names,
            )

    @property
    def dim_names(self) -> List[str]:
        return self.twister.matrix.row_names

    @property
    def kmer_names(self) -> List[str]:
        return self.twister.matrix.col_names

    # ---------------- file I/O ----------------

    def to_files(self, prefix: str, precision: int = 15) -> None:
        self.twister.to_table(prefix, precision=precision)
        self.inertia.to_table(prefix, precision=precision)

    @classmethod
    def of_files(cls, prefix: str) -> "Twister":
        t = cls(
            KPopMatrix.of_table(MatrixType.TWISTER, prefix),
            KPopMatrix.of_table(MatrixType.INERTIA, prefix),
        )
        t._check()
        return t

    def to_binary(self, prefix: str) -> None:
        path = with_ext(prefix, TWISTER_BIN_EXT)
        f = open_out_bin(path)
        try:
            framed.write_header(f, "KPopTwister")
            self.twister.matrix.write_frames(f)
            self.inertia.matrix.write_frames(f)
        finally:
            close_if_owned(f, path)

    @classmethod
    def of_binary(cls, prefix: str) -> "Twister":
        path = with_ext(prefix, TWISTER_BIN_EXT)
        f = open_in_bin(path)
        try:
            framed.read_header(f, expect_tag="KPopTwister")
            tw = NamedMatrix.read_frames(f)
            inertia = NamedMatrix.read_frames(f)
        finally:
            close_if_owned(f, path)
        t = cls(
            KPopMatrix(MatrixType.TWISTER, tw),
            KPopMatrix(MatrixType.INERTIA, inertia),
        )
        t._check()
        return t

    # ---------------- metric ----------------

    def metrics_vector(self, metric: Metric) -> np.ndarray:
        """lib/Twister.ml:208-209: the metric derived from the inertia row."""
        return metric.compute(np.asarray(self.inertia.matrix.data[0]))

    def metrics_matrix(self, metric: Metric) -> KPopMatrix:
        return KPopMatrix(
            MatrixType.METRICS,
            NamedMatrix(
                ["metrics"],
                list(self.inertia.matrix.col_names),
                self.metrics_vector(metric)[None, :],
            ),
        )

    # ---------------- projection ----------------

    def project_entries(
        self,
        entries_list: Sequence[Sequence[Tuple[str, float]]],
        normalize: bool = True,
        debug: bool = False,
        block_elements: int = int(2e7),
    ) -> np.ndarray:
        """Project spectra (lists of (kmer_label, count)) into twisted space.

        Matches lib/Twister.ml:146-188: unknown k-mers silently dropped,
        duplicates accumulated, optional normalization to sum 1 over the
        k-mers *found in the twister* (the reference accumulates ``acc``
        only inside the Some branch, :159-169).  Returns [n_spectra, d].

        Vectorized: labels are resolved against the sorted vocabulary with
        one ``searchsorted`` over the whole batch, spectra are scattered into
        blocked dense rows and projected with one matmul per block (the
        reference forks a per-spectrum sparse matvec).
        """
        import sys
        import time

        tw = np.asarray(self.twister.matrix.data, dtype=np.float64)  # [d, K]
        d, K = tw.shape
        n = len(entries_list)
        out = np.zeros((n, d))
        if n == 0:
            return out
        t0 = time.perf_counter() if debug else 0.0
        lens = np.fromiter((len(e) for e in entries_list), dtype=np.int64, count=n)
        all_names = [name for entries in entries_list for name, _ in entries]
        names_flat = (
            np.asarray(all_names) if all_names else np.zeros(0, dtype="U1")
        )
        vals_flat = np.fromiter(
            (v for entries in entries_list for _, v in entries),
            dtype=np.float64,
            count=int(lens.sum()),
        )
        sid_flat = np.repeat(np.arange(n), lens)
        vocab = (
            np.asarray(self.kmer_names)
            if self.kmer_names
            else np.zeros(0, dtype="U1")
        )
        order = np.argsort(vocab)
        sorted_vocab = vocab[order]
        if len(names_flat):
            pos = np.searchsorted(sorted_vocab, names_flat)
            pos_c = np.minimum(pos, max(K - 1, 0))
            known = (sorted_vocab[pos_c] == names_flat) if K else np.zeros(
                len(names_flat), dtype=bool
            )
            cols = order[pos_c[known]]
            vals = vals_flat[known]
            sids = sid_flat[known]
        else:
            cols = np.zeros(0, dtype=np.int64)
            vals = np.zeros(0)
            sids = np.zeros(0, dtype=np.int64)
        acc = np.bincount(sids, weights=vals, minlength=n)
        t1 = time.perf_counter() if debug else 0.0
        if normalize:
            vals = vals / np.where(acc == 0.0, 1.0, acc)[sids]
        t2 = time.perf_counter() if debug else 0.0
        # blocked dense scatter + matmul; peak extra memory ~block*K doubles
        block = max(1, block_elements // max(1, K))
        bounds = np.searchsorted(sids, np.arange(0, n + block, block))
        for bi, lo in enumerate(range(0, n, block)):
            hi = min(lo + block, n)
            elo, ehi = bounds[bi], bounds[bi + 1]
            x = np.zeros((hi - lo, K))
            np.add.at(x, (sids[elo:ehi] - lo, cols[elo:ehi]), vals[elo:ehi])
            out[lo:hi] = x @ tw.T
        if debug:
            # phase timing of the hidden --debug-twisting flag
            # (reference lib/Twister.ml:147,171-187); amortized per spectrum
            t3 = time.perf_counter()
            for si in range(n):
                sys.stderr.write(
                    "DEBUG=(lines=%d/%d/%d,%.3g,%.3g,%.3g)\n"
                    % (
                        lens[si],
                        K,
                        d,
                        (t1 - t0) / n,
                        (t2 - t1) / n,
                        (t3 - t2) / n,
                    )
                )
        return out

    def add_twisted_from_files(
        self,
        twisted: KPopMatrix,
        fnames: Sequence[str],
        normalize: bool = True,
        debug: bool = False,
    ) -> KPopMatrix:
        """Twist spectra from ``.KPopSpectra.txt`` files and append to a
        twisted register (lib/Twister.ml:58-206).  Row order follows the
        reference: all labels sorted (StringMap iteration)."""
        twisted.expect(MatrixType.TWISTED)
        twisted_col_names = (
            self.twister.matrix.row_names
            if twisted.matrix.n_rows == 0 and twisted.matrix.n_cols == 0
            else twisted.matrix.col_names
        )
        if self.twister.matrix.row_names != twisted_col_names:
            raise IncompatibleTwisterAndTwisted()
        rows: Dict[str, np.ndarray] = {
            n: np.asarray(twisted.matrix.data[i])
            for i, n in enumerate(twisted.matrix.row_names)
        }
        labels: List[str] = []
        batches: List[List[Tuple[str, float]]] = []
        for fname in fnames:
            f = open_in(fname)
            try:
                for label, entries in spectra_io.iter_spectra(f):
                    labels.append(label)
                    batches.append(entries)
            finally:
                close_if_owned(f, fname)
        projected = self.project_entries(batches, normalize=normalize, debug=debug)
        for label, row in zip(labels, projected):
            if label in rows:
                raise DuplicateLabel(label)
            rows[label] = row
        names = sorted(rows.keys())
        data = (
            np.stack([rows[n] for n in names], axis=0)
            if names
            else np.zeros((0, len(twisted_col_names)))
        )
        return KPopMatrix(
            MatrixType.TWISTED,
            NamedMatrix(names, list(twisted_col_names), data),
        )


# ---------------- training (the KPopTwist capability) ----------------


@dataclass
class TwistParameters:
    """Parameters of the bash front-end stub (bin/KPopTwist_.ml:19-36)."""

    kmers_keep: List[str] | None = None  # -k: keep-list of k-mer labels
    kmers_sample: float = 1.0  # -s: random fraction of k-mers
    transform: Transformation = field(
        default_factory=Transformation
    )  # --counts-*
    normalize: bool = True  # --counts-normalize
    threshold_kmers: float = 0.0  # --kmers-threshold
    seed: int | None = None  # sampling RNG (deviation: explicit seed)
    # kpop-tpu extension (--dims): keep only the leading CA dimensions.
    # The reference's R ca() keeps all min(dims)-1; truncation is the
    # single-chip mode for flagship vocabularies, where the full-dim
    # twister exceeds one device's HBM (benchmarks/flagship_ca.py) —
    # inertia stays normalized over the full non-trivial spectrum.
    n_dims: int | None = None


def twist_counter_db(
    db: CounterDB,
    params: TwistParameters | None = None,
    backend: str = "host",
    verbose: bool = False,
) -> Tuple[Twister, KPopMatrix, KPopMatrix]:
    """Train a twister from a counts DB: the whole ``src/KPopTwist`` pipeline
    (export -> filter -> sample -> threshold -> normalize -> CA) fused in
    memory.  Returns (twister, twisted sample coordinates, twisted k-mer
    principal coordinates — the ``-K`` output of src/KPopTwist:101-103)."""
    params = params or TwistParameters()
    filt = TableFilter(transform=params.transform)  # zero rows dropped
    # identity transform (KPopTwist's default) stays int32 end to end:
    # no float64 table copy, and the sharded CA uploads u8/u16 directly
    rows, cols, table = db.transformed_counts(filt)
    kmer_names = [n for n, _ in rows]
    sample_names = [n for n, _ in cols]
    # [4/16] keep-list filter (src/KPopTwist:76-82)
    if params.kmers_keep is not None:
        keep = set(params.kmers_keep)
        sel = [i for i, n in enumerate(kmer_names) if n in keep]
        kmer_names = [kmer_names[i] for i in sel]
        table = table[sel, :]
    # [5/16] random resampling (src/KPopTwist:83-86)
    if params.kmers_sample < 1.0:
        rng = np.random.default_rng(params.seed)
        n_keep = int(len(kmer_names) * params.kmers_sample)
        sel = np.sort(rng.choice(len(kmer_names), size=n_keep, replace=False))
        kmer_names = [kmer_names[i] for i in sel]
        table = table[sel, :]
    # [6/16] k-mer thresholding (src/KPopTwist:87-91)
    rsums = table.sum(axis=1)
    sel = np.nonzero(rsums >= rsums.max() * params.threshold_kmers)[0]
    kmer_names = [kmer_names[i] for i in sel]
    table = table[sel, :]
    # [7/16] per-spectrum normalization (src/KPopTwist:92-94) — kept as
    # separate column weights so the device CA can ship the (usually
    # integer) table on its compact wire path
    col_w = None
    if params.normalize:
        csums = table.sum(axis=0)
        col_w = 1.0 / np.where(csums == 0.0, 1.0, csums)
    # [8/16] twist
    if backend == "host":
        res = ca_mod.fit_ca(
            table if col_w is None else table * col_w[None, :],
            n_dims=params.n_dims,
        )
    elif backend in ("jax", "tpu", "sharded", "device"):
        # device CA: the compact wire upload, the fused residual-Gram
        # kernel, host float64 eigh, phi on the device; over the ranks of
        # the process group when there is one, each rank's rows on its card
        # (parallel/sharded.py)
        from ..parallel import distributed
        from ..parallel.mesh import make_mesh
        from ..parallel.sharded import ca_fit_sharded

        mesh = make_mesh() if distributed.world_size() > 1 else None
        coords, inertia, tw, sv = ca_fit_sharded(
            table, n_dims=params.n_dims, col_weights=col_w, verbose=verbose, mesh=mesh,
        )
        res = ca_mod.CAResult(
            sample_coords=coords.astype(np.float64),
            inertia=inertia.astype(np.float64),
            twister=tw.astype(np.float64),
            sv=sv.astype(np.float64),
            dim_names=["Dim%d" % (i + 1) for i in range(len(inertia))],
        )
    else:
        raise ValueError(f"unknown CA backend {backend!r}")
    twister = Twister(
        KPopMatrix(
            MatrixType.TWISTER,
            NamedMatrix(res.dim_names, kmer_names, res.twister),
        ),
        KPopMatrix(
            MatrixType.INERTIA,
            NamedMatrix(["inertia"], res.dim_names, res.inertia[None, :]),
        ),
    )
    twisted = KPopMatrix(
        MatrixType.TWISTED,
        NamedMatrix(sample_names, res.dim_names, res.sample_coords),
    )
    twisted_kmers = KPopMatrix(
        MatrixType.TWISTED,
        NamedMatrix(
            kmer_names, res.dim_names, (res.twister * res.sv[:, None]).T
        ),
    )
    return twister, twisted, twisted_kmers
