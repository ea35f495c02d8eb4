"""K-mer window encoding: the counterpart of ``kpop_tpu/ops/encode.py``.

Sequences are encoded on the host to int8 base codes (A=0 C=1 G=2 T=3,
protein 0..19, -1 = window break or padding) and batched into ``[B, L]``
arrays.  The k-limit helpers and :func:`encode_reads_host` are copies of
the JAX package's numpy-only helpers, which live in a module that imports
JAX; the tests hold them equal to the originals.

On the serving path the window codes are computed inside the counting and
embedding-bag kernels (``csrc/count_spectra.cu``, ``csrc/embedding_bag.cu``);
:func:`window_codes_batch` (k up to :func:`lut_k_max`, looked up in a dense
table) and :func:`window_codes_batch_wide` (two-limb codes for any k the
reference counts, looked up in a cuckoo hash or by
:func:`searchsorted_2limb`) are the plain PyTorch versions they are tested
against.

DNA read sets may also travel on the 2-bit wire of
``native.pack_2bit_batch`` (:func:`pack_reads_2bit`, :class:`PackedReads`):
3/8 of a byte a base where the codes take one.  The kernels read it as it
is; :func:`unpack_2bit_batch` is its plain version.

On a card the serving step uploads the sequences' raw bytes instead
(:class:`ByteRing`, one byte a base as the codes) and lints and encodes
them there (:func:`encode_bytes`, ``csrc/encode_bytes.cu``), with the codes
of :func:`encode_reads_host`.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from .. import _build

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


def window_codes_batch_wide(
    codes: torch.Tensor, k: int, canonical: bool, base: int = 4
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Two-limb window codes for any k the reference counts (DNA up to 30,
    protein up to 12): ``[B, L]`` base codes -> ``(hi, lo, ok)``, each
    ``[B, L-k+1]``, ``hi``/``lo`` int32.

    The full window code is ``hi * base**k_lo + lo`` with ``(k_hi, k_lo)``
    from :func:`split_k` (DNA k=30: two 30-bit limbs; DNA k <= 15 and
    protein k <= 7: ``hi`` is 0).  Lexicographic order on (hi, lo) is the
    numeric order of the full codes, so the canonical (DNA-ds) code is the
    lexicographically smaller of the forward and reverse-complement pairs.
    """
    if canonical and base != 4:
        raise ValueError("canonical encoding is DNA-only")
    k_hi, k_lo = split_k(k, base)
    c = codes.to(torch.int32)
    B, L = c.shape
    W = L - k + 1
    if W <= 0:
        raise ValueError(f"sequences shorter than k: L={L}, k={k}")

    def at(j):
        return c[:, j : j + W]

    ok = torch.ones((B, W), dtype=torch.bool, device=c.device)
    for j in range(k):
        ok &= at(j) >= 0

    def limb(positions, strand=lambda x: x):
        """The base-``base`` number of the bases at ``positions``, most
        significant first (Horner)."""
        out = torch.zeros((B, W), dtype=torch.int32, device=c.device)
        for j in positions:
            out = out * base + strand(at(j)).clamp(min=0)
        return out

    # forward limbs: hi = bases [0, k_hi), lo = bases [k_hi, k)
    fwd_hi = limb(range(k_hi))
    fwd_lo = limb(range(k_hi, k))
    if not canonical:
        return fwd_hi, fwd_lo, ok
    # reverse complement: rc = sum_i (3 - s[i]) base^i, so rc_hi holds
    # positions [k_lo, k) and rc_lo positions [0, k_lo), the last most
    # significant
    rc_hi = limb(reversed(range(k_lo, k)), lambda x: 3 - x)
    rc_lo = limb(reversed(range(k_lo)), lambda x: 3 - x)
    use_fwd = (fwd_hi < rc_hi) | ((fwd_hi == rc_hi) & (fwd_lo <= rc_lo))
    return (torch.where(use_fwd, fwd_hi, rc_hi), torch.where(use_fwd, fwd_lo, rc_lo), ok)


def _pair_key(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """int64 keys whose order is the lexicographic order of int32 pairs."""
    return hi.long() * (1 << 32) + (lo.long() + (1 << 31))


def searchsorted_2limb(
    vh: torch.Tensor, vl: torch.Tensor, qh: torch.Tensor, ql: torch.Tensor
) -> torch.Tensor:
    """Lower-bound search of (hi, lo) query pairs in the ``[V]`` int32
    limbs sorted by (hi, lo): the vocabulary index of each exact match, or
    ``V`` for a miss (int32), as the JAX ``searchsorted_2limb``.  Plain
    PyTorch: one ``torch.searchsorted`` on int64 pair keys."""
    V = int(vh.shape[0])
    if V == 0:
        return torch.zeros(qh.shape, dtype=torch.int32, device=qh.device)
    keys = _pair_key(vh, vl)
    q = _pair_key(qh, ql)
    pos = torch.searchsorted(keys, q.reshape(-1)).reshape(q.shape)
    found = (pos < V) & (keys[pos.clamp(max=V - 1)] == q)
    return torch.where(found, pos, torch.full_like(pos, V)).to(torch.int32)


def encode_reads_host(
    seqs: list[str], length: int | None = None, protein: bool = False
) -> np.ndarray:
    """Lint and encode sequences, padded to a common length with -1.

    Padding breaks windows at sequence ends.  Uses the native batch encoder
    (``kpop_tpu_torch/native``) when it is available, else numpy, with identical
    output.
    """
    from .. import native

    if native.available():
        return native.encode_batch(seqs, protein, length)
    from ..core.kmers import encode_dna, encode_protein

    enc = encode_protein if protein else encode_dna
    encoded = [enc(s) for s in seqs]
    L = length or max((len(e) for e in encoded), default=0)
    L = max(L, 1)
    out = np.full((len(encoded), L), -1, dtype=np.int8)
    for i, e in enumerate(encoded):
        out[i, : min(len(e), L)] = e[:L]
    return out


#: the bytes of a row that one block of ``csrc/encode_bytes.cu`` takes
ENCODE_CHUNK = 16384
#: most positions (bases, or bytes on the bytes wire) a read set takes on a
#: card: the kernels index the positions and windows of a read set in
#: int32, and a block may run up to 2^16 positions past a row's end.  A
#: batch's offsets (read set times its row) are 64-bit in every kernel.
READ_MAX_BASES = 2**31 - 2**16


def check_row_length(name: str, n: int) -> None:
    """Raise a ``ValueError`` for read sets of more than
    :data:`READ_MAX_BASES` positions, which the kernels' int32 positions
    cannot take."""
    if n > READ_MAX_BASES:
        raise ValueError(f"{name}: read sets of {n} positions; the kernels take at most "
                         f"{READ_MAX_BASES} a read set (int32 positions)")


def encode_bytes(rows: torch.Tensor, lengths: torch.Tensor, width: int,
                 table: torch.Tensor) -> torch.Tensor:
    """Raw sequence bytes ``rows [B, stride]`` u8, of which row ``b`` holds
    ``lengths[b]`` (int32), -> ``[B, width]`` int8 base codes: each byte's
    code in ``table`` (int8 ``[256]``, ``core/kmers.py``'s ``_DNA_CODE`` or
    ``_PROT_CODE``: -1 breaks the windows, -2 is the dash), dashes removed
    with their flanks joined, -1 past each row's encoded length (truncated
    at ``width``).  Bytes past a row's length are not read.  On the common
    columns these are :func:`encode_reads_host`'s codes; a wider ``width``
    adds -1 columns, which break every window and count nothing.

    On a card, ``csrc/encode_bytes.cu``, which refuses a ``stride`` that is
    not a multiple of 16 or rows off a 16-byte boundary; on the CPU,
    :func:`encode_bytes_ref`."""
    if rows.dim() != 2 or rows.dtype != torch.uint8:
        raise TypeError(f"encode_bytes: rows must be [B, stride] uint8, not {rows.dtype} "
                        f"{tuple(rows.shape)}")
    B, stride = rows.shape
    if lengths.shape != (B,) or lengths.dtype != torch.int32:
        raise TypeError(f"encode_bytes: lengths must be [{B}] int32")
    if table.shape != (256,) or table.dtype != torch.int8:
        raise TypeError("encode_bytes: the table must be [256] int8")
    if width < 1:
        raise ValueError(f"encode_bytes: width {width} < 1")
    check_row_length("encode_bytes", max(stride, width))
    if rows.device.type == "cpu":
        return encode_bytes_ref(rows, lengths, width, table)
    _build.check_cuda("encode_bytes", rows, lengths, table,
                      dtypes=(torch.uint8, torch.int32, torch.int8))
    chunks = -(-max(stride, width) // ENCODE_CHUNK)
    out = torch.empty((B, width), dtype=torch.int8, device=rows.device)
    work = torch.empty(B * (chunks + 1), dtype=torch.int32, device=rows.device)
    _build.launch("kpop_encode_bytes", rows.data_ptr(), lengths.data_ptr(), B, stride, width,
                  table.data_ptr(), work.data_ptr(), out.data_ptr())
    return out


def encode_bytes_ref(rows: torch.Tensor, lengths: torch.Tensor, width: int,
                     table: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of :func:`encode_bytes`: the table
    gathered, then the kept bytes compacted by a ``cumsum``."""
    B, stride = rows.shape
    codes = table[rows.long()]
    length = lengths.long().clamp(0, stride)
    keep = (torch.arange(stride, device=rows.device) < length[:, None]) & (codes != -2)
    dest = keep.long().cumsum(1) - 1
    keep &= dest < width
    out = torch.full((B, width), -1, dtype=torch.int8, device=rows.device)
    r, c = keep.nonzero(as_tuple=True)
    out[r, dest[r, c]] = codes[r, c]
    return out


_AS_UTF8 = ctypes.PYFUNCTYPE(ctypes.c_void_p, ctypes.py_object,
                             ctypes.POINTER(ctypes.c_ssize_t))(
    ("PyUnicode_AsUTF8AndSize", ctypes.pythonapi))


def _utf8(seq) -> tuple:
    """``(source, n)``: the address of a ``str``'s own UTF-8 buffer (for an
    ASCII string its data; for another, the bytes ``seq.encode()`` gives,
    which the string keeps), or a bytes object itself, and its length."""
    if isinstance(seq, str):
        n = ctypes.c_ssize_t()
        return _AS_UTF8(seq, ctypes.byref(n)), n.value
    seq = bytes(seq)
    return seq, len(seq)


class StagedBytes(NamedTuple):
    """A batch staged by :class:`ByteRing`: ``buffer`` holds ``rows`` rows
    of ``stride`` bytes, then their ``[rows]`` int32 byte lengths;
    ``longest`` is the batch's longest sequence in bytes; ``sources`` the
    rows to copy in (:func:`_utf8`)."""

    buffer: torch.Tensor
    rows: int
    stride: int
    longest: int
    sources: list

    def split(self, buffer: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
        """``(rows [rows, stride] u8, lengths [rows] int32)`` on ``buffer``
        (by default the staged one; or its copy on a card)."""
        buf = self.buffer if buffer is None else buffer
        at = self.rows * self.stride
        return buf[:at].view(self.rows, self.stride), buf[at:].view(torch.int32)


class ByteRing:
    """Two reused host buffers (pinned where a card takes them), used in
    turn, that stage a batch's sequences as raw bytes for one upload.

    :meth:`reserve` takes the next buffer, waits for its last upload
    (recorded by :meth:`uploaded`; done already when the batch that used it
    was drained), grows it where the batch is larger and writes the rows'
    lengths; :meth:`fill` copies each row straight from the sequence's own
    buffer (:func:`_utf8`), with no encode, join or pinned copy.  A row
    starts at a multiple of its stride, the batch's longest sequence
    rounded up to 16 bytes; nothing past a row's length is written."""

    SLOTS = 2

    def __init__(self, pinned: bool):
        self.pinned = pinned
        self._buffers = [torch.empty(0, dtype=torch.uint8) for _ in range(self.SLOTS)]
        self._uploads: list[torch.cuda.Event | None] = [None] * self.SLOTS
        self._turn = 0

    def reserve(self, seqs, r0: int = 0, r1: int | None = None) -> StagedBytes:
        """The rows ``[r0, r1)`` of the batch ``seqs`` (rows past its end
        have length 0) on the next buffer, their lengths written."""
        r1 = len(seqs) if r1 is None else r1
        sources = [_utf8(s) for s in seqs]
        longest = max((n for _, n in sources), default=0)
        stride = -(-max(longest, 1) // 16) * 16
        rows = r1 - r0
        need = rows * (stride + 4)
        slot = self._turn
        self._turn = (slot + 1) % self.SLOTS
        if self._uploads[slot] is not None:
            self._uploads[slot].synchronize()
            self._uploads[slot] = None
        if self._buffers[slot].numel() < need:
            self._buffers[slot] = torch.empty(need, dtype=torch.uint8, pin_memory=self.pinned)
        mine = sources[r0:r1]
        staged = StagedBytes(self._buffers[slot][:need], rows, stride, longest, mine)
        lengths = staged.split()[1].numpy()
        lengths[: len(mine)] = [n for _, n in mine]
        lengths[len(mine):] = 0
        return staged

    @staticmethod
    def fill(staged: StagedBytes) -> None:
        """Copy each row's bytes into the staged buffer."""
        base, stride = staged.buffer.data_ptr(), staged.stride
        for i, (src, n) in enumerate(staged.sources):
            ctypes.memmove(base + i * stride, src, n)

    def uploaded(self) -> None:
        """Record, on the current stream, the end of the upload of the
        buffer :meth:`reserve` last took."""
        done = torch.cuda.Event()
        done.record()
        self._uploads[(self._turn - 1) % self.SLOTS] = done


def packed_strides(length: int) -> tuple[int, int]:
    """The row strides of the 2-bit wire for read sets of ``length``
    bases: ``(packed bytes, valid bytes)``, 4 bases and 8 validity bits a
    byte."""
    return (length + 3) // 4, (length + 7) // 8


class PackedReads(NamedTuple):
    """``B`` read sets of ``length`` bases on the 2-bit wire: ``packed [B,
    (length + 3) // 4]`` u8 (base ``j`` in bits ``2 (j & 3)`` of byte ``j
    >> 2``) and ``valid [B, (length + 7) // 8]`` u8 (bit ``j & 7`` of byte
    ``j >> 3`` set where position ``j`` is a base).  DNA only: a base takes
    2 bits.  ``count_spectra`` and ``project_reads`` take it in place of
    ``[B, length]`` int8 codes."""

    packed: torch.Tensor
    valid: torch.Tensor
    length: int

    @property
    def shape(self) -> tuple[int, int]:
        return (self.packed.shape[0], self.length)

    @property
    def device(self) -> torch.device:
        return self.packed.device


def unpack_2bit_batch(packed: torch.Tensor, valid: torch.Tensor, length: int) -> torch.Tensor:
    """The 2-bit wire -> ``[B, length]`` int8 base codes, -1 where a
    position is no base: the counterpart of
    ``kpop_tpu/ops/encode.py::unpack_2bit_batch`` (which returns int32), in
    the dtype the port's kernels take.  The plain version of the kernels'
    packed reads."""
    j = torch.arange(length, device=packed.device)
    base = (packed[:, j >> 2].to(torch.int32) >> ((j & 3) * 2)) & 3
    ok = (valid[:, j >> 3].to(torch.int32) >> (j & 7)) & 1
    return torch.where(ok == 1, base, -1).to(torch.int8)


def as_codes(reads) -> torch.Tensor:
    """``[B, L]`` int8 codes of int8 codes or :class:`PackedReads`."""
    if isinstance(reads, PackedReads):
        return unpack_2bit_batch(*reads)
    return reads


def pack_reads_2bit(codes: np.ndarray, base: int = 4) -> tuple[np.ndarray, np.ndarray]:
    """``[B, L]`` int8 base codes -> the 2-bit wire ``(packed [B, (L + 3)
    // 4], valid [B, (L + 7) // 8])`` u8, as ``native.pack_2bit_batch``
    writes it (numpy, with the same bytes, where the library is missing).
    DNA only: the packer ORs a code above 3 into its neighbours' bits, so
    any other alphabet raises."""
    if base != 4:
        raise ValueError(f"the 2-bit wire holds DNA bases (base 4), not base {base}")
    from .. import native

    codes = np.ascontiguousarray(codes, dtype=np.int8)
    if native.available():
        return native.pack_2bit_batch(codes)
    n, L = codes.shape
    ps, _vs = packed_strides(L)
    ok = codes >= 0
    c = np.zeros((n, 4 * ps), dtype=np.uint8)
    c[:, :L] = np.where(ok, codes, 0).astype(np.uint8)
    packed = np.zeros((n, ps), dtype=np.uint8)
    for i in range(4):  # uint8 shifts: a code's bits above the byte drop, as in C
        packed |= c[:, i::4] << np.uint8(2 * i)
    return packed, np.packbits(ok, axis=1, bitorder="little")


def spectra_from_codes(
    window_codes: torch.Tensor,
    valid: torch.Tensor,
    n_kmers: int,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Window codes ``[B, W]`` with their validity ``[B, W]`` -> dense
    spectra ``[B, n_kmers]``: the counterpart of
    ``kpop_tpu/ops/encode.py::spectra_from_codes``.  Invalid windows go to a
    trash column, which is dropped; plain PyTorch (``index_add_``)."""
    B, W = window_codes.shape
    tgt = torch.where(valid, window_codes.long(), n_kmers)
    tgt = tgt + torch.arange(B, device=tgt.device)[:, None] * (n_kmers + 1)
    out = torch.zeros(B * (n_kmers + 1), dtype=dtype, device=window_codes.device)
    out.index_add_(0, tgt.reshape(-1), torch.ones(B * W, dtype=dtype, device=out.device))
    return out.view(B, n_kmers + 1)[:, :n_kmers]
