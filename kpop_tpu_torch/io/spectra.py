"""Reader/writer for the ``.KPopSpectra.txt`` text spectrum stream.

Format (producer: reference bin/KPopCount.ml:33-46; consumers:
lib/KMerDB.ml:505-575, lib/Twister.ml:96-145): records of a header line
``\\t<label>`` followed by ``<kmer_hex>\\t<count>`` lines; multiple spectra are
concatenated; repeated k-mer labels within one spectrum are legal and must be
accumulated downstream (``-M`` eviction, bin/KPopCount.ml:116-123).
"""

from __future__ import annotations

from typing import IO, Iterator, List, Tuple

from ..utils.naming import SPECTRA_EXT, with_ext
from ..utils.quoting import strip_external_quotes_and_check


def spectra_filename(prefix: str) -> str:
    return with_ext(prefix, SPECTRA_EXT)


class SpectraFormatError(ValueError):
    pass


def iter_spectra(f: IO[str]) -> Iterator[Tuple[str, List[Tuple[str, float]]]]:
    """Yield ``(label, [(kmer_label, count), ...])`` per spectrum.

    Duplicate k-mer labels are *not* merged here; callers accumulate
    (lib/KMerDB.ml:561-562, lib/Twister.ml:159-166).
    """
    label = None
    entries: List[Tuple[str, float]] = []
    line_num = 0
    for line in f:
        line_num += 1
        parts = line.rstrip("\n").split("\t")
        if len(parts) != 2:
            if parts == [""]:
                continue
            raise SpectraFormatError(
                f"line {line_num}: expected 2 fields, found {len(parts)}"
            )
        if parts[0] == "":
            if label is not None:
                yield label, entries
            label = strip_external_quotes_and_check(parts[1])
            entries = []
        else:
            if label is None:
                raise SpectraFormatError(f"line {line_num}: header expected")
            entries.append((parts[0], float(parts[1])))
    if label is not None:
        yield label, entries


def write_spectrum_header(f: IO[str], label: str) -> None:
    f.write("\t%s\n" % label)


def write_spectrum_entries(f: IO[str], labels, counts) -> None:
    write = f.write
    for kl, c in zip(labels, counts):
        ci = int(c)
        if ci == c:
            write("%s\t%d\n" % (kl, ci))
        else:
            write("%s\t%.15g\n" % (kl, c))
