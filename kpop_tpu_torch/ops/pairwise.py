"""Metric-weighted euclidean distance tiles: the counterpart of
``kpop_tpu/ops/pallas_pairwise.py``.

:func:`distance_tile` computes, for ``a [Q, D]``, ``b [T, D]``, weights
``m [D]`` and row scales ``na [Q]``, ``nb [T]``,

    d[q, t] = sqrt(max(0, na2_q + nb2_t - 2 (a_q/na_q * m) . (b_t/nb_t)))

with ``na2``/``nb2`` the weighted squared norms of the scaled rows: the
expansion of the Pallas kernel ``_dist_kernel``.  On a CUDA tensor it
launches ``csrc/pairwise.cu``; on a CPU tensor it runs
:func:`distance_tile_ref`, the plain PyTorch version.
"""

from __future__ import annotations

import torch

from .. import _build


def distance_tile_ref(
    a: torch.Tensor,
    b: torch.Tensor,
    m: torch.Tensor,
    na: torch.Tensor,
    nb: torch.Tensor,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`distance_tile` (f32 throughout)."""
    a = a / na[:, None]
    b = b / nb[:, None]
    am = a * m[None, :]
    cross = am @ b.T
    na2 = (am * a).sum(dim=1)
    nb2 = (b * b * m[None, :]).sum(dim=1)
    return torch.sqrt(torch.clamp(na2[:, None] + nb2[None, :] - 2.0 * cross, min=0.0))


def distance_tile(
    a: torch.Tensor,
    b: torch.Tensor,
    m: torch.Tensor,
    na: torch.Tensor,
    nb: torch.Tensor,
) -> torch.Tensor:
    """``[Q, D] x [T, D] -> [Q, T]`` distances of the rows scaled by
    ``1/na`` and ``1/nb`` (see the module docstring)."""
    Q, D = a.shape
    T = b.shape[0]
    if b.shape != (T, D) or m.shape != (D,) or na.shape != (Q,) or nb.shape != (T,):
        raise ValueError(
            f"distance_tile: shapes a {tuple(a.shape)}, b {tuple(b.shape)}, "
            f"m {tuple(m.shape)}, na {tuple(na.shape)}, nb {tuple(nb.shape)}"
        )
    if a.device.type == "cpu":
        return distance_tile_ref(a, b, m, na, nb)
    f32 = torch.float32
    _build.check_cuda("distance_tile", a, b, m, na, nb, dtypes=(f32,) * 5)
    if Q >= 65535 * 64:
        raise ValueError(f"distance_tile: Q={Q} exceeds the kernel's grid")
    out = torch.empty((Q, T), dtype=f32, device=a.device)
    _build.launch(
        "kpop_pairwise_dist",
        a.data_ptr(), b.data_ptr(), m.data_ptr(), na.data_ptr(),
        nb.data_ptr(), out.data_ptr(), Q, T, D,
    )
    return out


def row_norms(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Row norms ``sqrt(sum m x^2)`` with 0 replaced by 1."""
    n = torch.sqrt((x * x * m[None, :]).sum(dim=1))
    return torch.where(n == 0.0, torch.ones_like(n), n)


def _prepare(queries, targets, metric, normalize):
    m = metric.to(torch.float32).contiguous()
    a = queries.to(torch.float32).contiguous()
    b = targets.to(torch.float32).contiguous()
    if normalize:
        na, nb = row_norms(a, m), row_norms(b, m)
    else:
        na = torch.ones(a.shape[0], dtype=torch.float32, device=a.device)
        nb = torch.ones(b.shape[0], dtype=torch.float32, device=b.device)
    return a, b, m, na, nb


def pairwise_distances(
    queries: torch.Tensor,
    targets: torch.Tensor,
    metric: torch.Tensor,
    normalize: bool = True,
) -> torch.Tensor:
    """``[Q, D] x [T, D] -> [Q, T]`` metric-weighted euclidean distances,
    with the semantics of ``pairwise_distances_pallas``: with ``normalize``
    every row is first divided by its norm ``sqrt(sum m x^2)`` (0 -> 1)."""
    return distance_tile(*_prepare(queries, targets, metric, normalize))


def pairwise_distances_ref(
    queries: torch.Tensor,
    targets: torch.Tensor,
    metric: torch.Tensor,
    normalize: bool = True,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`pairwise_distances`."""
    return distance_tile_ref(*_prepare(queries, targets, metric, normalize))
