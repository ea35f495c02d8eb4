"""The count engine: reads -> k-mer spectra (the ``KPopCount`` capability).

Re-design of reference bin/KPopCount.ml:20-64 (``KMerCounter.compute``):
instead of a bounded hash table fed one k-mer at a time, sequences are
encoded to integer codes and whole windows are counted vectorized; for
k <= DENSE_K_MAX a dense 4^k spectrum is used (the representation the TPU
pipeline consumes directly), above that a sparse (codes, counts) merge.

Observable behaviour matches the reference:

- ``-l`` single-label mode: one spectrum accumulated over all reads; if more
  than ``max_results_size`` distinct hashes are in memory the table is
  dumped and cleared, producing legal duplicate hashes in the output
  (bin/KPopCount.ml:39-50,116-123);
- ``-L`` per-sequence mode: one spectrum per input sequence, labelled with
  the sequence tag (bin/KPopCount.ml:173-179).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import IO, Iterable, Sequence, Tuple

import numpy as np

from ..config import DENSE_K_MAX
from ..io import spectra as spectra_io
from ..io.reads import ReadsInput, iter_reads
from ..utils.quoting import strip_external_quotes_and_check
from .kmers import KmerSpace, encode_dna, encode_protein

DEFAULT_MAX_RESULTS_SIZE = 16_777_216  # 4^12, bin/KPopCount.ml:89


def content_encoder(content: str):
    if content not in ("DNA-ss", "DNA-ds", "protein"):
        raise ValueError(f"unknown content {content!r}")
    protein = content == "protein"
    try:
        from .. import native

        if native.available():
            nat = native.encode_protein if protein else native.encode_dna

            def enc(seq):
                return nat(seq.encode() if isinstance(seq, str) else seq)

            return enc
    except ImportError:
        pass
    return encode_protein if protein else encode_dna


@dataclass
class SpectrumAccumulator:
    """Accumulates window codes; dense below DENSE_K_MAX, sparse above.

    The sparse store is the native open-addressing hash when available
    (the reference counts any k at hash speed via
    ``KMers.IntHashFrequencies``, bin/KPopCount.ml:111-123; the numpy
    fallback's per-read sorted merge is quadratic over reads) — set
    ``use_native=False`` to force the pure-numpy golden path.
    """

    space: KmerSpace
    dense: np.ndarray | None = None
    use_native: bool = True
    sparse_codes: np.ndarray = field(default_factory=lambda: np.zeros(0, np.uint64))
    sparse_counts: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    native_hash: object | None = field(default=None, repr=False)

    def __post_init__(self):
        # dense only when the code space itself is small (4^DENSE_K_MAX
        # entries); a base-20 protein space outgrows that at much lower k
        if self.space.n_kmers <= 4**DENSE_K_MAX and self.dense is None:
            self.dense = np.zeros(self.space.n_kmers, dtype=np.int64)
        elif self.dense is None and self.use_native:
            try:
                from .. import native

                if native.available():
                    self.native_hash = native.SparseCounter()
            except ImportError:
                pass

    def add(self, codes: np.ndarray) -> None:
        if codes.size == 0:
            return
        if self.dense is not None:
            np.add.at(self.dense, codes.astype(np.int64), 1)
        elif self.native_hash is not None:
            self.native_hash.add_codes(codes)
        else:
            cs, ct = np.unique(codes, return_counts=True)
            # merge sorted (codes, counts) runs
            allc = np.concatenate([self.sparse_codes, cs])
            alln = np.concatenate([self.sparse_counts, ct])
            order = np.argsort(allc, kind="stable")
            allc, alln = allc[order], alln[order]
            uniq, inv = np.unique(allc, return_inverse=True)
            merged = np.zeros(len(uniq), dtype=np.int64)
            np.add.at(merged, inv, alln)
            self.sparse_codes, self.sparse_counts = uniq, merged

    @property
    def n_distinct(self) -> int:
        if self.dense is not None:
            return int(np.count_nonzero(self.dense))
        if self.native_hash is not None:
            return len(self.native_hash)
        return len(self.sparse_codes)

    def nonzero(self) -> Tuple[np.ndarray, np.ndarray]:
        """(codes, counts), sorted by code."""
        if self.dense is not None:
            nz = np.nonzero(self.dense)[0]
            return nz.astype(np.uint64), self.dense[nz]
        if self.native_hash is not None:
            return self.native_hash.extract()
        return self.sparse_codes, self.sparse_counts

    def clear(self) -> None:
        if self.dense is not None:
            self.dense.fill(0)
        elif self.native_hash is not None:
            self.native_hash.clear()
        else:
            self.sparse_codes = np.zeros(0, np.uint64)
            self.sparse_counts = np.zeros(0, np.int64)


def _dump(acc: SpectrumAccumulator, out: IO[str]) -> None:
    codes, counts = acc.nonzero()
    emitted = False
    try:
        from .. import native
    except ImportError:
        native = None
    if native is not None and native.available() and len(codes):
        # one C call instead of a per-entry "%0*x / %d" loop — the
        # KPopCount output stream is the pipeline's hot producer
        # (reference bin/KPopCount.ml:46 streams via OCaml printf)
        blob = native.format_spectra_entries(
            codes, counts, acc.space.hex_width
        )
        if blob is not None:
            out.write(blob.decode("ascii"))
            emitted = True
    if not emitted:
        spectra_io.write_spectrum_entries(
            out, acc.space.codes_to_hex(codes), counts
        )
    acc.clear()


def _native_counter(space: KmerSpace):
    """C++ fast path: encode + rolling-code count straight into the dense
    spectrum (kpop_tpu/native), when applicable."""
    if space.content == "protein" or space.k > DENSE_K_MAX:
        return None
    try:
        from .. import native
    except ImportError:
        return None
    if not native.available():
        return None
    canonical = space.canonical

    def count_into(seq: str, dense: np.ndarray) -> None:
        codes = native.encode_dna(
            seq.encode() if isinstance(seq, str) else seq
        )
        native.get_lib().kpop_count_dense(
            codes.ctypes.data_as(native._i8p),
            len(codes),
            space.k,
            int(canonical),
            dense.ctypes.data_as(native._i64p),
        )

    return count_into


def _native_sparse_counter(space: KmerSpace):
    """C++ fast path for the large-k sparse store: encode + rolling-code
    count straight into the accumulator's open-addressing hash."""
    if space.n_kmers <= 4**DENSE_K_MAX:
        return None  # the dense path owns small code spaces
    try:
        from .. import native
    except ImportError:
        return None
    if not native.available():
        return None
    protein = space.content == "protein"
    nat_enc = native.encode_protein if protein else native.encode_dna
    k, canonical, base = space.k, space.canonical, space.base

    def count_into(seq, acc: SpectrumAccumulator) -> None:
        codes = nat_enc(seq.encode() if isinstance(seq, str) else seq)
        acc.native_hash.count_seq(codes, k, canonical, base)

    return count_into


#: flush the -l read batch when the padded encode matrix would exceed this
BATCH_ENCODE_BYTES = 64 << 20


def count_reads(
    inputs: Sequence[ReadsInput],
    space: KmerSpace,
    out: IO[str],
    label: str = "",
    max_results_size: int = DEFAULT_MAX_RESULTS_SIZE,
    threads: int | None = None,
) -> int:
    """Stream reads, count k-mers, write text spectra.  Returns #reads.

    ``label == ""`` selects per-sequence (-L) mode, matching the reference's
    convention (bin/KPopCount.ml:39-50).

    ``threads``: in ``-l`` mode, reads are counted in native batches with
    per-thread hashes (or relaxed-atomic dense adds) merged afterwards —
    output is byte-identical to the sequential path.  Batching only
    happens when the -M eviction threshold provably cannot trigger inside
    the batch (distinct k-mers grow by at most the batched base count), so
    dump-and-clear timing matches the per-read semantics exactly
    (bin/KPopCount.ml:116-123).  Default is 1: the reference defaults to
    nproc, but the serial hash merge bounds the win at low k-mer
    duplication, and on the measured 2-vCPU dev host nproc is a slight
    regression — many-core users opt in with -t.
    """
    encoder = content_encoder(space.content)
    acc = SpectrumAccumulator(space)
    native_count = _native_counter(space)
    native_sparse = _native_sparse_counter(space)
    threads = 1 if threads in (None, 0) else max(1, threads)
    if label != "":
        spectra_io.write_spectrum_header(
            out, strip_external_quotes_and_check(label)
        )
    protein = space.content == "protein"
    dense_mode = native_count is not None and acc.dense is not None
    sparse_mode = native_sparse is not None and acc.native_hash is not None
    batching = label != "" and (dense_mode or sparse_mode)

    def can_evict() -> bool:
        if acc.dense is not None:
            return max_results_size < acc.dense.shape[0]
        return True

    def check_evict() -> None:
        if can_evict() and acc.n_distinct >= max_results_size:
            _dump(acc, out)

    batch: list = []  # [(segments tuple)] per read, -l mode only
    batch_chars = 0
    batch_maxlen = 1

    def flush_batch() -> None:
        nonlocal batch, batch_chars, batch_maxlen
        if not batch:
            return
        from .. import native

        # safe to count the whole batch at once only if eviction cannot
        # trigger inside it: distinct grows by at most batch_chars
        if not can_evict() or (
            acc.n_distinct + batch_chars < max_results_size
        ):
            segs = [s for read in batch for s in read]
            codes = native.encode_batch(segs, protein)
            if dense_mode:
                native.count_dense_batch(
                    codes, space.k, space.canonical, out=acc.dense,
                    threads=threads,
                )
            else:
                acc.native_hash.count_batch(
                    codes, space.k, space.canonical, space.base,
                    threads=threads,
                )
            check_evict()
        else:
            # eviction may fire mid-batch: per-read, reference timing
            for read in batch:
                for seq in read:
                    if dense_mode:
                        native_count(seq, acc.dense)
                    else:
                        native_sparse(seq, acc)
                check_evict()
        batch = []
        batch_chars = 0
        batch_maxlen = 1

    n_reads = 0
    for tag, segments in iter_reads(inputs):
        if batching:
            seg_max = max((len(s) for s in segments), default=1)
            n_flat = sum(len(r) for r in batch) + len(segments)
            if batch and n_flat * max(batch_maxlen, seg_max) > \
                    BATCH_ENCODE_BYTES:
                flush_batch()
            batch.append(tuple(segments))
            batch_chars += sum(len(s) for s in segments)
            batch_maxlen = max(batch_maxlen, seg_max)
            n_reads += 1
            continue
        if dense_mode:
            for seq in segments:
                native_count(seq, acc.dense)
        elif sparse_mode:
            for seq in segments:
                native_sparse(seq, acc)
        else:
            for seq in segments:
                acc.add(space.window_codes(encoder(seq)))
        n_reads += 1
        if label == "":
            spectra_io.write_spectrum_header(
                out, strip_external_quotes_and_check(tag)
            )
            _dump(acc, out)
        else:
            check_evict()
    if label != "":
        flush_batch()
        _dump(acc, out)
    return n_reads


def spectrum_of_sequences(
    space: KmerSpace, sequences: Iterable[str], use_native: bool = True
) -> Tuple[np.ndarray, np.ndarray]:
    """In-memory convenience: (codes, counts) of a set of sequences."""
    encoder = content_encoder(space.content)
    acc = SpectrumAccumulator(space, use_native=use_native)
    for seq in sequences:
        acc.add(space.window_codes(encoder(seq)))
    return acc.nonzero()
