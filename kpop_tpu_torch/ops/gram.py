"""The CA Gram of the standardized residual, rebuilt from the compact table.

:func:`residual_gram` computes, in float64,

    G = S^T S,   S[k, j] = x[k, j] alpha[k] beta[j] - u[k] v[j]

for a wire table ``x [K, ns]`` (u8, u16, f32 or f64) and float64 vectors
``alpha, u [K]`` and ``beta, v [ns]``: the Gram that
``kpop_tpu/parallel/sharded.py::ca_fit_sharded`` accumulates in
double-double limbs with a Kahan carry on the TPU.  On a CUDA tensor it
launches ``csrc/ca_gram.cu``, which rebuilds S one chunk at a time in
shared memory and multiplies on the FP64 tensor cores, over
:func:`split_plan`'s slices of the k-mer axis, summed in a fixed order.
It factors ``S = beta alpha (x - rho gamma)`` (:func:`factors`) to spend
less float64 arithmetic on the rebuild, which is exact where ``alpha = 0``
implies ``u = 0`` and ``beta = 0`` implies ``v = 0`` (the CA's vectors are
so by construction); elsewhere the Gram comes out NaN, never wrong.
On a CPU tensor it runs :func:`residual_gram_ref`, the plain PyTorch
version.
"""

from __future__ import annotations

import functools

import torch

from .. import _build

#: output tile edge and k-mer rows per chunk of the CUDA kernel
TILE = 64
CHUNK = 32
#: blocks of the kernel resident on a streaming multiprocessor (its
#: registers allow two), and the waves of them the split-K grid aims at
RESIDENT_PER_SM = 2
WAVES = 3
#: streaming multiprocessors of an H100 SXM
H100_SMS = 132
#: wire dtype -> the kernel's template code
WIRE_CODES = {torch.uint8: 0, torch.uint16: 1, torch.float32: 2, torch.float64: 3}
_INT_MAX = 2**31 - 1


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _cdiv(x: int, y: int) -> int:
    return -(-x // y)


def tile_pairs(ns: int) -> list[tuple[int, int]]:
    """The kernel's output tiles ``(bi, bj)``, ``bi <= bj``, in the order of
    ``blockIdx.x`` (row bi holds bj = bi, ..., nb - 1)."""
    nb = _cdiv(ns, TILE)
    return [(bi, bj) for bi in range(nb) for bj in range(bi, nb)]


def split_plan(K: int, ns: int, n_sm: int = H100_SMS, waves: int = WAVES) -> tuple[int, int]:
    """``(slices, rows_per_slice)`` of the split-K grid: about ``waves``
    whole waves of resident blocks over the upper tiles, a whole number of
    chunks per slice, and no empty slice.  Slice ``s`` covers rows
    ``[s R, min(K, (s + 1) R))``."""
    tiles = len(tile_pairs(ns))
    chunks = max(1, _cdiv(K, CHUNK))
    want = max(1, min(chunks, _cdiv(waves * RESIDENT_PER_SM * n_sm, max(tiles, 1))))
    rows = CHUNK * _cdiv(chunks, want)
    return max(1, _cdiv(K, rows)), rows


def factors(alpha, u, beta, v) -> tuple[torch.Tensor, torch.Tensor]:
    """``rho = u / alpha`` and ``gamma = v / beta``, with which
    ``S = beta alpha (x - rho gamma)``: 0 where both the divisor and the
    dividend are 0, NaN where only the divisor is (there S has no such
    factors, and the kernel's Gram comes out NaN).  The plain version of
    the kernel's first step (``factors_kernel``)."""

    def ratio(num, den):
        fill = torch.where(num == 0, 0.0, float("nan")).to(num.dtype)
        return torch.where(den != 0, num / torch.where(den != 0, den, 1.0), fill)

    return ratio(u, alpha), ratio(v, beta)


def residual(x, alpha, u, beta, v) -> torch.Tensor:
    """The standardized residual ``x alpha beta - u v`` of rows of ``x``, in
    float64 (plain PyTorch)."""
    return x.double() * alpha[:, None] * beta[None, :] - u[:, None] * v[None, :]


def residual_gram_ref(x, alpha, u, beta, v, block_bytes: int = 64 << 20) -> torch.Tensor:
    """Plain PyTorch version of :func:`residual_gram`: S rebuilt in float64
    in row blocks of about ``block_bytes``, and their ``S^T S`` summed."""
    K, ns = x.shape
    G = torch.zeros((ns, ns), dtype=torch.float64, device=x.device)
    step = max(1, block_bytes // max(1, ns * 8))
    for i in range(0, K, step):
        S = residual(x[i : i + step], alpha[i : i + step], u[i : i + step], beta, v)
        G += S.T @ S
    return G


def residual_gram(x, alpha, u, beta, v, waves: int = WAVES) -> torch.Tensor:
    """``[K, ns]`` wire table and its scaling vectors -> ``G [ns, ns]``
    float64 (see the module docstring); ``waves`` sizes the CUDA kernel's
    split-K grid (:func:`split_plan`)."""
    K, ns = x.shape
    if alpha.shape != (K,) or u.shape != (K,) or beta.shape != (ns,) or v.shape != (ns,):
        raise ValueError(
            f"residual_gram: shapes x {tuple(x.shape)}, alpha {tuple(alpha.shape)}, "
            f"u {tuple(u.shape)}, beta {tuple(beta.shape)}, v {tuple(v.shape)}"
        )
    if x.dtype not in WIRE_CODES:
        raise TypeError(f"residual_gram: wire dtype {x.dtype} is not one of {list(WIRE_CODES)}")
    if x.device.type == "cpu":
        return residual_gram_ref(x, alpha, u, beta, v)
    f64 = torch.float64
    _build.check_cuda(
        "residual_gram", x, alpha, u, beta, v, dtypes=(x.dtype,) + (f64,) * 4
    )
    if K == 0 or ns == 0:
        return torch.zeros((ns, ns), dtype=f64, device=x.device)
    if K + ns > _INT_MAX or ns * ns > _INT_MAX:
        raise ValueError(f"residual_gram: K={K}, ns={ns} exceed the kernel's int range")
    out = torch.empty((ns, ns), dtype=f64, device=x.device)  # every entry written
    slices, rows = split_plan(K, ns, _sm_count(x.device), waves)
    # rho and gamma, then the slices' partial Grams
    ws = torch.empty(K + ns + (slices * ns * ns if slices > 1 else 0), dtype=f64, device=x.device)
    _build.launch(
        "kpop_ca_gram",
        x.data_ptr(), WIRE_CODES[x.dtype], K, ns, alpha.data_ptr(), u.data_ptr(),
        beta.data_ptr(), v.data_ptr(), slices, rows, out.data_ptr(), ws.data_ptr(),
    )
    return out
