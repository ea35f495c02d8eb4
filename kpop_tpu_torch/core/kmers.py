"""K-mer encoding, canonicalization and hex labels.

Re-provides the capabilities of BiOCamLib's ``KMers.DNAHashSingleStranded``,
``KMers.DNAHashDoubleStrandedLexicographic`` and ``KMers.ProteinHash``
(consumed at the reference's bin/KPopCount.ml:239-249; the submodule is not
vendored in the reference snapshot, so the encoding below is this project's
own definition — it only needs to be internally consistent, since hex labels
are join keys between pipeline stages, cf. lib/Twister.ml:151).

Encoding
--------
DNA: 2 bits/base, A=0 C=1 G=2 T=3, first base most significant, so the
integer order equals lexicographic order and the double-stranded canonical
form is ``min(code(s), code(revcomp(s)))``.  k <= 30 (60 bits, uint64 —
README.md:326).

Protein: base-20 over the alphabet ``ACDEFGHIKLMNPQRSTVWY``, first residue
most significant.  k <= 12 (20^12 < 2^63).

Hex labels are lowercase, zero-padded to the fixed width needed for the
largest code of the given (alphabet, k), e.g. k=5 DNA -> 3 hex digits.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# ---------------- alphabets & linting ----------------

DNA_ALPHABET = "ACGT"
PROTEIN_ALPHABET = "ACDEFGHIKLMNPQRSTVWY"

_DNA_CODE = np.full(256, -1, dtype=np.int8)
for _i, _c in enumerate(DNA_ALPHABET):
    _DNA_CODE[ord(_c)] = _i
    _DNA_CODE[ord(_c.lower())] = _i
_DNA_CODE[ord("U")] = _DNA_CODE[ord("T")]
_DNA_CODE[ord("u")] = _DNA_CODE[ord("T")]
# '-' marked for deletion (gap removal joins flanks, Sequences.Lint ~keep_dashes:false)
_DASH = -2
_DNA_CODE[ord("-")] = _DASH

_PROT_CODE = np.full(256, -1, dtype=np.int8)
for _i, _c in enumerate(PROTEIN_ALPHABET):
    _PROT_CODE[ord(_c)] = _i
    _PROT_CODE[ord(_c.lower())] = _i
_PROT_CODE[ord("-")] = _DASH


def encode_dna(seq: str | bytes) -> np.ndarray:
    """Lint + encode a DNA sequence to int8 codes (-1 = break, dashes removed).

    Mirrors ``Sequences.Lint.dnaize ~keep_lowercase:false ~keep_dashes:false``
    (bin/KPopCount.ml:242): lowercase accepted, dashes removed, U -> T,
    any other character (incl. ambiguity codes) breaks the k-mer window.
    """
    if isinstance(seq, str):
        seq = seq.encode()
    raw = np.frombuffer(seq, dtype=np.uint8)
    codes = _DNA_CODE[raw]
    return codes[codes != _DASH]


def encode_protein(seq: str | bytes) -> np.ndarray:
    if isinstance(seq, str):
        seq = seq.encode()
    raw = np.frombuffer(seq, dtype=np.uint8)
    codes = _PROT_CODE[raw]
    return codes[codes != _DASH]


# ---------------- k-mer spaces ----------------


@dataclass(frozen=True)
class KmerSpace:
    """All static properties of a (content, k) pair."""

    content: str  # 'DNA-ss' | 'DNA-ds' | 'protein'
    k: int

    def __post_init__(self):
        if self.content in ("DNA-ss", "DNA-ds"):
            if not (0 < self.k <= 30):
                raise ValueError(f"DNA k must be in 1..30, got {self.k}")
        elif self.content == "protein":
            if not (0 < self.k <= 12):
                raise ValueError(f"protein k must be in 1..12, got {self.k}")
        else:
            raise ValueError(f"unknown content {self.content!r}")

    @property
    def base(self) -> int:
        return 4 if self.content.startswith("DNA") else 20

    @property
    def n_kmers(self) -> int:
        """Size of the full code space (4^k or 20^k)."""
        return self.base**self.k

    @property
    def canonical(self) -> bool:
        return self.content == "DNA-ds"

    @property
    def hex_width(self) -> int:
        return len("%x" % (self.n_kmers - 1))

    # ---- label <-> code ----

    def code_to_hex(self, code: int) -> str:
        return "%0*x" % (self.hex_width, code)

    def codes_to_hex(self, codes: np.ndarray) -> list[str]:
        w = self.hex_width
        return ["%0*x" % (w, int(c)) for c in codes]

    def hex_to_code(self, label: str) -> int:
        return int(label, 16)

    def code_to_string(self, code: int) -> str:
        """Decode a code back to its sequence (for docs/debugging)."""
        alpha = DNA_ALPHABET if self.base == 4 else PROTEIN_ALPHABET
        out = []
        for _ in range(self.k):
            out.append(alpha[code % self.base])
            code //= self.base
        return "".join(reversed(out))

    # ---- windowed codes over an encoded sequence ----

    def window_codes(self, codes: np.ndarray) -> np.ndarray:
        """Codes of every valid k-window of an encoded sequence.

        Invalid windows (containing a break) are dropped.  For DNA-ds the
        canonical (min of strand/revcomp) code is returned — the hot loop of
        ``KIH.iterc`` (bin/KPopCount.ml:38), vectorized.
        """
        k, base = self.k, self.base
        n = len(codes) - k + 1
        if n <= 0:
            return np.zeros(0, dtype=np.uint64)
        c64 = codes.astype(np.int64)
        fwd = np.zeros(n, dtype=np.uint64)
        mult = 1
        for j in range(k - 1, -1, -1):
            fwd += np.where(c64[j : j + n] > 0, c64[j : j + n], 0).astype(
                np.uint64
            ) * np.uint64(mult)
            mult *= base
        ok = codes >= 0
        csum = np.concatenate([[0], np.cumsum(ok)])
        valid = (csum[k:] - csum[:-k]) == k
        fwd = fwd[valid]
        if not self.canonical:
            return fwd
        # reverse complement: complement = 3 - b, reversed order
        comp = 3 - c64
        rc = np.zeros(n, dtype=np.uint64)
        mult = 1
        for j in range(k):
            rc += np.where(c64[j : j + n] >= 0, comp[j : j + n], 0).astype(
                np.uint64
            ) * np.uint64(mult)
            mult *= base
        rc = rc[valid]
        return np.minimum(fwd, rc)


_HEX_CHARS = np.frombuffer(b"0123456789abcdef", dtype=np.uint8)


def hex_labels_vectorized(codes: np.ndarray, width: int) -> list[str]:
    """Fixed-width lowercase hex labels for a vector of codes, fully
    vectorized (the per-code ``"%0*x"`` formatting is an ingest hotspot)."""
    codes = np.asarray(codes, dtype=np.uint64)
    n = len(codes)
    if n == 0:
        return []
    shifts = np.arange(width - 1, -1, -1, dtype=np.uint64) * np.uint64(4)
    nibbles = (codes[:, None] >> shifts[None, :]) & np.uint64(0xF)
    chars = _HEX_CHARS[nibbles.astype(np.int64)]
    flat = chars.reshape(n * width).tobytes().decode("ascii")
    return [flat[i * width : (i + 1) * width] for i in range(n)]


def count_codes_dense(space: KmerSpace, codes: np.ndarray, out: np.ndarray) -> None:
    """Accumulate window codes into a dense spectrum array (int64)."""
    np.add.at(out, codes.astype(np.int64), 1)


def count_codes_sparse(codes: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Unique codes + counts, sorted by code."""
    return np.unique(codes, return_counts=True)
