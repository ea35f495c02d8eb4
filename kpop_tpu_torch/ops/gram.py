"""The CA Gram of the standardized residual, rebuilt from the compact table.

:func:`residual_gram` computes, in float64,

    G = S^T S,   S[k, j] = x[k, j] alpha[k] beta[j] - u[k] v[j]

for a wire table ``x [K, ns]`` (u8, u16, f32 or f64) and float64 vectors
``alpha, u [K]`` and ``beta, v [ns]``: the Gram that
``kpop_tpu/parallel/sharded.py::ca_fit_sharded`` accumulates in
double-double limbs with a Kahan carry on the TPU.  On a CUDA tensor it
launches ``csrc/ca_gram.cu``, which rebuilds S one chunk at a time in
shared memory and multiplies on the FP64 tensor cores, over
:func:`split_plan`'s slices of the k-mer axis, each slice's upper tiles
kept in a partial of its own and the slices summed in a fixed order.
It factors ``S = beta alpha (x - rho gamma)`` (:func:`factors`) to spend
less float64 arithmetic on the rebuild, which is exact where ``alpha = 0``
implies ``u = 0`` and ``beta = 0`` implies ``v = 0`` (the CA's vectors are
so by construction); elsewhere the Gram comes out NaN, never wrong.
On a CPU tensor it runs :func:`residual_gram_ref`, the plain PyTorch
version.

:class:`GramAccumulator` sums the Gram of a table given in row blocks (the
streamed CA fit): its partials live for the whole pass, each block adds
into them, and :meth:`GramAccumulator.finish` sums the slices once.
:func:`residual_gram` is one block and a finish.  On the CPU the
accumulator runs the same order in plain PyTorch (:func:`accumulate_ref`,
:func:`finish_ref`).
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
    whole waves of :data:`RESIDENT_PER_SM` blocks an SM over the upper
    tiles, a whole number of chunks per slice, and no empty slice.  Slice
    ``s`` covers rows ``[s R, min(K, (s + 1) R))``."""
    tiles = len(tile_pairs(ns))
    chunks = max(1, _cdiv(K, CHUNK))
    want = max(1, min(chunks, _cdiv(waves * RESIDENT_PER_SM * n_sm, max(tiles, 1))))
    slices = max(1, _cdiv(K, CHUNK * _cdiv(chunks, want)))
    return slices, slice_rows(K, slices)


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
    float64 (plain PyTorch), scaled in place: it needs one temporary of its
    own size (the outer product ``u v``) beside itself."""
    S = x.to(torch.float64, copy=True)
    S.mul_(alpha[:, None]).mul_(beta[None, :])
    return S.sub_(torch.outer(u, v))


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


def slice_rows(K: int, slices: int) -> int:
    """Rows a slice of a block of ``K`` rows over ``slices`` slices: a
    whole number of chunks, the slices past the block's rows empty."""
    return CHUNK * _cdiv(max(1, _cdiv(K, CHUNK)), slices)


def partial_doubles(ns: int, slices: int) -> int:
    """float64 partials of the CUDA kernel: an ``[ns, ns]`` a slice, of
    which the kernel touches the upper tiles."""
    return slices * ns * ns


def accumulator_doubles(rows: int, ns: int, n_sm: int = H100_SMS, waves: int = WAVES) -> int:
    """float64 device memory of a :class:`GramAccumulator` for blocks of up
    to ``rows`` rows, G included: the partials, rho and gamma, and G."""
    slices = split_plan(rows, ns, n_sm, waves)[0]
    return partial_doubles(ns, slices) + rows + ns + ns * ns


def accumulate_ref(partial, x, alpha, u, beta, v) -> None:
    """Plain version of one block of :class:`GramAccumulator`: slice ``s``
    of the block's rows adds ``sum_k (alpha[k] T[k, i]) (alpha[k] T[k, j])``,
    ``T = x - rho gamma`` (:func:`factors`), into ``partial[s]``, unscaled,
    as the kernel does."""
    slices = partial.shape[0]
    rho, gamma = factors(alpha, u, beta, v)
    R = slice_rows(x.shape[0], slices)
    for s in range(slices):
        k0, k1 = s * R, min(x.shape[0], (s + 1) * R)
        if k0 < k1:
            A = alpha[k0:k1, None] * (x[k0:k1].double() - rho[k0:k1, None] * gamma[None, :])
            partial[s] += A.T @ A


def finish_ref(partial, beta) -> torch.Tensor:
    """Plain version of :meth:`GramAccumulator.finish`: the slices added in
    order, then scaled by ``beta[i] beta[j]``."""
    G = partial[0].clone()
    for s in range(1, partial.shape[0]):
        G += partial[s]
    return G * (beta[:, None] * beta[None, :])


class GramAccumulator:
    """``G = sum_b S_b^T S_b`` over row blocks ``b`` of one table, with the
    column vectors ``beta, v [ns]`` of the whole table: :meth:`add` each
    block (up to ``rows`` rows, with its ``alpha, u``), then :meth:`finish`.

    The slices of the split-K grid are fixed by ``rows`` (:func:`split_plan`
    at ``waves``) and their partials live until :meth:`finish`: block after
    block adds its slices' upper tiles into them in place, and the finish
    adds the slices in order, scales by ``beta[i] beta[j]`` and mirrors.  So
    each entry of G is the sum over slices, in order, of the blocks in
    order: the same from run to run.  The device memory it holds is
    :func:`accumulator_doubles`."""

    def __init__(self, beta: torch.Tensor, v: torch.Tensor, rows: int, waves: int = WAVES):
        ns = beta.shape[0]
        f64 = torch.float64
        if v.shape != (ns,) or beta.dtype != f64 or v.dtype != f64 or v.device != beta.device:
            raise ValueError("GramAccumulator: beta and v must be [ns] float64 on one device")
        self.beta, self.v, self.rows, self.ns = beta, v, max(1, rows), ns
        self.device = beta.device
        self.cuda = self.device.type == "cuda"
        n_sm = _sm_count(self.device) if self.cuda else H100_SMS
        self.slices = split_plan(self.rows, ns, n_sm, waves)[0]
        self.blocks = 0
        if self.cuda:
            _build.check_cuda("GramAccumulator", beta, v, dtypes=(f64, f64))
            if self.rows + ns > _INT_MAX or ns * ns > _INT_MAX:
                raise ValueError(f"GramAccumulator: rows={rows}, ns={ns} exceed the kernel's "
                                 "int range")
            self.partial = torch.empty(partial_doubles(ns, self.slices), dtype=f64,
                                       device=self.device)  # the first block writes it
            self.factors = torch.empty(self.rows + ns, dtype=f64, device=self.device)
        else:
            self.partial = torch.zeros((self.slices, ns, ns), dtype=f64)

    def add(self, x: torch.Tensor, alpha: torch.Tensor, u: torch.Tensor) -> None:
        """Add the Gram of the row block ``x [K, ns]`` with its ``alpha, u
        [K]``."""
        K, ns = x.shape
        if ns != self.ns or alpha.shape != (K,) or u.shape != (K,) or K > self.rows:
            raise ValueError(
                f"GramAccumulator.add: x {tuple(x.shape)}, alpha {tuple(alpha.shape)}, "
                f"u {tuple(u.shape)} for blocks of up to {self.rows} rows of {self.ns} columns"
            )
        if x.dtype not in WIRE_CODES:
            raise TypeError(f"residual_gram: wire dtype {x.dtype} is not one of "
                            f"{list(WIRE_CODES)}")
        if K == 0:
            return
        if not self.cuda:
            accumulate_ref(self.partial, x, alpha, u, self.beta, self.v)
            self.blocks += 1
            return
        f64 = torch.float64
        if x.device != self.device:
            raise ValueError(f"GramAccumulator.add: x on {x.device}, the accumulator on "
                             f"{self.device}")
        _build.check_cuda("residual_gram", x, alpha, u, dtypes=(x.dtype, f64, f64))
        _build.launch(
            "kpop_ca_gram",
            x.data_ptr(), WIRE_CODES[x.dtype], K, ns, alpha.data_ptr(), u.data_ptr(),
            self.beta.data_ptr(), self.v.data_ptr(), self.slices,
            slice_rows(K, self.slices), self.partial.data_ptr(), self.factors.data_ptr(),
            int(self.blocks == 0),
        )
        self.blocks += 1

    def finish(self) -> torch.Tensor:
        """``G [ns, ns]`` float64 of the blocks added so far."""
        ns, f64 = self.ns, torch.float64
        if not self.cuda:
            return finish_ref(self.partial, self.beta)
        if self.blocks == 0:
            return torch.zeros((ns, ns), dtype=f64, device=self.device)
        G = torch.empty((ns, ns), dtype=f64, device=self.device)  # every entry written
        _build.launch("kpop_ca_gram_finish", self.partial.data_ptr(), self.slices, ns,
                      self.beta.data_ptr(), G.data_ptr())
        return G


def residual_gram(x, alpha, u, beta, v, waves: int = WAVES) -> torch.Tensor:
    """``[K, ns]`` wire table and its scaling vectors -> ``G [ns, ns]``
    float64 (see the module docstring): one block of a
    :class:`GramAccumulator` and its finish on a card, whose split-K grid
    ``waves`` sizes (:func:`split_plan`); :func:`residual_gram_ref` on the
    CPU."""
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
    _build.check_cuda(
        "residual_gram", x, alpha, u, beta, v, dtypes=(x.dtype,) + (torch.float64,) * 4
    )
    acc = GramAccumulator(beta, v, K, waves)
    acc.add(x, alpha, u)
    return acc.finish()
