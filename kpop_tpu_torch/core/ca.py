"""Correspondence analysis — the mathematical core of "twisting".

Replaces the reference's delegation to R's ``ca`` package
(src/KPopTwist:95-116) with an in-house implementation designed for TPUs:
instead of a full SVD of the huge ``[n_kmers, n_samples]`` standardized
residual matrix S, we eigendecompose the small ``[n_samples, n_samples]``
Gram matrix ``G = S^T S`` (n_samples << n_kmers), which is exact, and turn
the factors into the three artefacts the reference pipeline emits:

- ``twisted``  — sample principal coordinates  (R ``cacoord(cols=TRUE)``),
- ``inertia``  — ``sv^2 / sum(sv^2)``          (src/KPopTwist:104-108),
- ``twister``  — k-mer *standard* row coordinates (principal / sv),
                 transposed to [dims, n_kmers]  (src/KPopTwist:109-116).

Key property (exact, see the derivation in tests/test_ca.py): for any
training column profile p (column normalized to sum 1),
``twister @ p == sample principal coordinates`` — which is why projecting a
*new* normalized spectrum through the twister embeds it in the same space
(lib/Twister.ml:146-188).

Number of dimensions: ``min(n_kmers, n_samples) - 1`` like R's ``ca``.

The Gram matrix accumulation is the only O(n_kmers) step and is expressed as
a single matmul — on TPU it runs on the MXU and shards over the k-mer axis
(see :mod:`kpop_tpu.parallel.ca_sharded`).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class CAResult:
    sample_coords: np.ndarray  # [n_samples, d]  principal coordinates
    inertia: np.ndarray  # [d]
    twister: np.ndarray  # [d, n_kmers]  standard row coordinates^T
    sv: np.ndarray  # [d] singular values (row principal = standard * sv)
    dim_names: list[str]

    @property
    def n_dims(self) -> int:
        return len(self.inertia)


class DegenerateTable(ValueError):
    pass


def fit_ca(table: np.ndarray, n_dims: int | None = None) -> CAResult:
    """Fit CA on a non-negative ``[n_kmers, n_samples]`` table (float64).

    Rows or columns with zero mass are tolerated: they get zero coordinates
    (the reference pipeline drops zero rows before R ever sees them,
    lib/KMerDB.ml:1023).
    """
    N = np.asarray(table, dtype=np.float64)
    nk, ns = N.shape
    if nk == 0 or ns == 0:
        raise DegenerateTable(N.shape)
    total = N.sum()
    if total <= 0:
        raise DegenerateTable("table sums to zero")
    P = N / total
    r = P.sum(axis=1)  # row masses [nk]
    c = P.sum(axis=0)  # col masses [ns]
    r_safe = np.where(r > 0, r, 1.0)
    c_safe = np.where(c > 0, c, 1.0)
    # standardized residuals S = D_r^-1/2 (P - r c^T) D_c^-1/2
    S = (P - np.outer(r, c)) / np.sqrt(np.outer(r_safe, c_safe))
    # Gram matrix over the small sample axis
    G = S.T @ S  # [ns, ns]
    evals, evecs = np.linalg.eigh(G)  # ascending
    order = np.argsort(evals)[::-1]
    evals, evecs = evals[order], evecs[:, order]
    # d is capped at the non-trivial spectrum min(nk,ns)-1: centering
    # makes the trailing eigenvalue exactly zero in exact arithmetic, and
    # an over-large n_dims request would otherwise keep a pure-noise phi
    # column (||S v|| ~ sv, so phi = S v / sv cancels to an O(1) garbage
    # direction that distorts downstream projections)
    d_full = max(1, min(nk, ns) - 1)
    d = d_full if n_dims is None else max(1, min(n_dims, d_full))
    # total inertia over the full non-trivial spectrum, so n_dims
    # truncation reports each dim's share of the whole, matching R ca()'s
    # sv^2/sum(sv^2) over its nd = min(dim)-1 computed values
    total_in = float(np.maximum(evals[:d_full], 0.0).sum())
    evals = np.maximum(evals[:d], 0.0)
    V = evecs[:, :d]  # right singular vectors of S
    sv = np.sqrt(evals)
    # deterministic sign convention: largest-|.| component of each V column
    # is positive (R's svd signs are arbitrary; parity is up to column sign)
    signs = np.sign(V[np.argmax(np.abs(V), axis=0), np.arange(d)])
    signs = np.where(signs == 0, 1.0, signs)
    V = V * signs[None, :]
    # sample principal coordinates G_cols = D_c^-1/2 V Sigma
    sample_coords = V * sv[None, :] / np.sqrt(c_safe)[:, None]
    # k-mer standard coordinates Phi = D_r^-1/2 U = D_r^-1/2 S V Sigma^-1
    sv_safe = np.where(sv > 0, sv, 1.0)
    phi = (S @ (V / sv_safe[None, :])) / np.sqrt(r_safe)[:, None]  # [nk, d]
    phi = np.where((r > 0)[:, None], phi, 0.0)
    inertia = evals / total_in if total_in > 0 else evals
    dim_names = ["Dim%d" % (i + 1) for i in range(d)]
    return CAResult(
        sample_coords=sample_coords,
        inertia=inertia,
        twister=phi.T,
        sv=sv,
        dim_names=dim_names,
    )
