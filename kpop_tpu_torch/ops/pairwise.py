"""Metric-weighted euclidean distance tiles: the counterpart of
``kpop_tpu/ops/pallas_pairwise.py``.

:func:`distance_tile` computes, for ``a [Q, D]``, ``b [T, D]``, weights
``m [D]`` and row scales ``na [Q]``, ``nb [T]``,

    d[q, t] = sqrt(max(0, na2_q + nb2_t - 2 (a_q/na_q * m) . (b_t/nb_t)))

with ``na2``/``nb2`` the weighted squared norms of the scaled rows: the
expansion of the Pallas kernel ``_dist_kernel``.  On a CUDA tensor it
launches ``csrc/pairwise.cu``: the cross term on the tensor cores in split
TF32 (``hi + lo`` halves of each value, three TF32 products summed in f32),
over :func:`split_plan`'s slices of the feature axis, summed in a fixed
order.  On a CPU tensor it runs :func:`distance_tile_ref`, the plain
PyTorch version.
"""

from __future__ import annotations

import functools

import torch

from .. import _build

#: rows of ``a`` and of ``b`` per block of the CUDA kernel (csrc/pairwise.cu)
TILE = 128
#: features per split-K granule: the K of one wgmma step
SPLIT_UNIT = 8
#: streaming multiprocessors of an H100 SXM
H100_SMS = 132
#: CUDA's limit on grid.y; grid.x takes up to 2**31 - 1
_GRID_Y_MAX = 65535
_INT_MAX = 2**31 - 1


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _cdiv(x: int, y: int) -> int:
    return -(-x // y)


def tile_grid(Q: int, T: int) -> tuple[int, int]:
    """``(grid.x, grid.y)`` of the kernel's output tiles: the larger tile
    count on x, the smaller on y.  Raises when a grid dimension, or an
    ``int`` argument of the kernel (``Q``, ``T``, and ``Q + T`` rows of its
    norm pass), is out of range."""
    tiles = sorted((_cdiv(Q, TILE), _cdiv(T, TILE)))
    if tiles[0] > _GRID_Y_MAX or Q + T > _INT_MAX:
        raise ValueError(f"distance_tile: Q={Q}, T={T} exceed the kernel's grid")
    return tiles[1], tiles[0]


def split_plan(Q: int, T: int, D: int, n_sm: int = H100_SMS) -> list[int]:
    """Bounds ``[0, f_1, ..., D]`` of the feature slices of the split-K
    grid: ``S = n_sm // tiles`` slices (at least 1, at most one per
    granule), so that output tiles x slices fill about one wave of blocks.
    Slice ``s`` is ``[SPLIT_UNIT * (s U // S), SPLIT_UNIT * ((s+1) U // S))``
    with ``U = ceil(D / SPLIT_UNIT)``, clipped to ``D``: the same integer
    formula as the kernel's."""
    tiles = _cdiv(Q, TILE) * _cdiv(T, TILE)
    units = max(1, _cdiv(D, SPLIT_UNIT))
    S = max(1, min(units, n_sm // max(tiles, 1)))
    return [min(D, SPLIT_UNIT * (s * units // S)) for s in range(S + 1)]


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
    tile_grid(Q, T)
    if D > _INT_MAX:
        raise ValueError(f"distance_tile: D={D} exceeds the kernel's int range")
    if any(t.data_ptr() % 16 for t in (a, b, m)):
        raise ValueError("distance_tile: a, b and m must start on 16 bytes (cp.async)")
    S = len(split_plan(Q, T, D, _sm_count(a.device))) - 1
    out = torch.empty((Q, T), dtype=f32, device=a.device)
    # the row norms, then the slices' partial cross terms when S > 1
    ws = torch.empty(Q + T + (S * Q * T if S > 1 else 0), dtype=f32, device=a.device)
    _build.launch(
        "kpop_pairwise_dist",
        a.data_ptr(), b.data_ptr(), m.data_ptr(), na.data_ptr(),
        nb.data_ptr(), out.data_ptr(), ws.data_ptr(), Q, T, D, S,
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
