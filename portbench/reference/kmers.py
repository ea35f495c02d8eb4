"""Canonical DNA k-mers: the vocabulary, window indices and counts.

A base is 0-3 for A, C, G, T; anything else breaks a window.  A window's
code puts its first base in the most significant place, and the
double-stranded (canonical) code is the smaller of the code and its
reverse complement's (the convention of upstream KPop's hex labels).
"""

from __future__ import annotations

import numpy as np
import torch

#: ASCII -> base code, -1 for every other byte
ASCII_CODES = np.full(256, -1, dtype=np.int8)
for _i, _c in enumerate(b"ACGT"):
    ASCII_CODES[_c] = _i
    ASCII_CODES[_c + 32] = _i
#: base code (0-3, 4 for a break) -> ASCII
BASE_CHARS = np.frombuffer(b"ACGTN", dtype=np.uint8)


def canonical_codes(k: int) -> np.ndarray:
    """The sorted canonical codes of every DNA k-mer (int64):
    (4^k + 4^(k/2)) / 2 of them for even k."""
    codes = np.arange(4**k, dtype=np.int64)
    rc = np.zeros_like(codes)
    x = codes.copy()
    for _ in range(k):
        rc = rc * 4 + (3 - x % 4)
        x //= 4
    return codes[codes <= rc]


def hex_labels(codes: np.ndarray, k: int) -> list[str]:
    """Fixed-width lowercase hex labels of the codes, as a twister names
    its rows."""
    width = max(1, -(-2 * k // 4))
    return ["%0*x" % (width, int(c)) for c in codes]


def lookup_table(k: int, vocab: np.ndarray) -> np.ndarray:
    """code -> vocabulary row over all 4^k codes, ``len(vocab)`` where a
    code is not in ``vocab``."""
    lut = np.full(4**k, len(vocab), dtype=np.int64)
    lut[vocab] = np.arange(len(vocab))
    return lut


def encode(seqs: list[str]) -> np.ndarray:
    """Strings -> ``[n, L]`` int8 base codes, padded with -1."""
    L = max((len(s) for s in seqs), default=1)
    out = np.full((len(seqs), L), -1, dtype=np.int8)
    for i, s in enumerate(seqs):
        out[i, : len(s)] = ASCII_CODES[np.frombuffer(s.encode("ascii"), dtype=np.uint8)]
    return out


def window_rows(codes: torch.Tensor, k: int, lut: torch.Tensor, V: int) -> torch.Tensor:
    """``[n, L]`` base codes (negative or above 3 for a break) -> ``[n,
    L-k+1]`` vocabulary rows of each window's canonical code, ``V`` for a
    window that holds a break or whose k-mer is outside the vocabulary."""
    c = codes.to(torch.int64)
    ok_base = (c >= 0) & (c <= 3)
    c = torch.where(ok_base, c, torch.zeros_like(c))
    W = c.shape[1] - k + 1
    fwd = torch.zeros((c.shape[0], W), dtype=torch.int64, device=c.device)
    rc = torch.zeros_like(fwd)
    ok = torch.ones((c.shape[0], W), dtype=torch.bool, device=c.device)
    for j in range(k):
        fwd = fwd * 4 + c[:, j : j + W]
        rc = rc + (3 - c[:, j : j + W]) * 4**j
        ok &= ok_base[:, j : j + W]
    rows = lut[torch.minimum(fwd, rc)]
    return torch.where(ok, rows, torch.full_like(rows, V))


def counts(codes: torch.Tensor, k: int, lut: torch.Tensor, V: int, chunk: int = 8) -> torch.Tensor:
    """``[n, V]`` int64 k-mer counts of each row of ``codes`` over the
    vocabulary, ``chunk`` rows at a time."""
    n = codes.shape[0]
    out = torch.empty((n, V), dtype=torch.int64, device=codes.device)
    for i in range(0, n, chunk):
        rows = window_rows(codes[i : i + chunk], k, lut, V)
        m = rows.shape[0]
        flat = rows + torch.arange(m, device=rows.device)[:, None] * (V + 1)
        out[i : i + m] = torch.bincount(flat.reshape(-1), minlength=m * (V + 1)).view(m, V + 1)[:, :V]
    return out
