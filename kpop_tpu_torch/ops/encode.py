"""K-mer window encoding: the counterpart of ``kpop_tpu/ops/encode.py``.

Sequences are encoded on the host to int8 base codes (A=0 C=1 G=2 T=3,
protein 0..19, -1 = window break or padding) and batched into ``[B, L]``
arrays.  The k-limit helpers and :func:`encode_reads_host` are copies of
the JAX package's numpy-only helpers, which live in a module that imports
JAX; the tests hold them equal to the originals.

On the serving path the window codes are computed inside the counting and
embedding-bag kernels (``csrc/count_spectra.cu``, ``csrc/embedding_bag.cu``);
:func:`window_codes_batch` is the plain PyTorch version they are tested
against.  Two-limb codes for k above :func:`lut_k_max` are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

# Largest dense-LUT size for the code -> vocabulary map (int32 entries):
# 2^24 + 1 covers DNA k=12 exactly.
LUT_ENTRIES_MAX = (1 << 24) + 1


def device_k_max(base: int) -> int:
    """Largest k whose codes fit int32 for the given alphabet size."""
    k = 0
    while base ** (k + 1) < 2**31:
        k += 1
    return k


def lut_k_max(base: int) -> int:
    """Largest k for which the dense code->vocab LUT path is used."""
    k = 0
    while base ** (k + 1) + 1 <= LUT_ENTRIES_MAX and k + 1 <= device_k_max(base):
        k += 1
    return k


def split_k(k: int, base: int) -> tuple[int, int]:
    """Split k into (k_hi, k_lo) limb widths, each fitting int32 codes."""
    k_lo = min(k, device_k_max(base))
    k_hi = k - k_lo
    if k_hi > device_k_max(base):
        raise ValueError(f"k={k} too large for two-limb base-{base} codes")
    return k_hi, k_lo


def window_codes_batch(
    codes: torch.Tensor, k: int, canonical: bool, base: int = 4
) -> tuple[torch.Tensor, torch.Tensor]:
    """``[B, L]`` int8/int32 base codes -> (window codes ``[B, L-k+1]``
    int32, valid mask ``[B, L-k+1]`` bool).

    For canonical (DNA double-stranded) encoding the code is
    ``min(forward, revcomp)``; windows that touch a -1 are invalid.
    """
    if k > device_k_max(base):
        raise ValueError(
            f"device path supports k <= {device_k_max(base)} for base "
            f"{base}, got {k}"
        )
    if canonical and base != 4:
        raise ValueError("canonical encoding is DNA-only")
    c = codes.to(torch.int32)
    B, L = c.shape
    W = L - k + 1
    if W <= 0:
        raise ValueError(f"sequences shorter than k: L={L}, k={k}")
    fwd = torch.zeros((B, W), dtype=torch.int32, device=c.device)
    ok = torch.ones((B, W), dtype=torch.bool, device=c.device)
    mult = base ** (k - 1)
    for j in range(k):
        cj = c[:, j : j + W]
        fwd += cj.clamp(min=0) * mult
        ok &= cj >= 0
        mult //= base
    if not canonical:
        return fwd, ok
    rc = torch.zeros((B, W), dtype=torch.int32, device=c.device)
    mult = 1
    for j in range(k):
        rc += (3 - c[:, j : j + W]).clamp(min=0) * mult
        mult *= base
    return torch.minimum(fwd, rc), ok


def encode_reads_host(
    seqs: list[str], length: int | None = None, protein: bool = False
) -> np.ndarray:
    """Lint and encode sequences, padded to a common length with -1.

    Padding breaks windows at sequence ends.  Uses the native batch encoder
    (``kpop_tpu/native``) when it is available, else numpy, with identical
    output.
    """
    from kpop_tpu import native

    if native.available():
        return native.encode_batch(seqs, protein, length)
    from kpop_tpu.core.kmers import encode_dna, encode_protein

    enc = encode_protein if protein else encode_dna
    encoded = [enc(s) for s in seqs]
    L = length or max((len(e) for e in encoded), default=0)
    L = max(L, 1)
    out = np.full((len(encoded), L), -1, dtype=np.int8)
    for i, e in enumerate(encoded):
        out[i, : min(len(e), L)] = e[:L]
    return out
