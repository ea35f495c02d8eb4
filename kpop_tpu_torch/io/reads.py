"""Streaming FASTA/FASTQ readers.

Re-provides the capability of BiOCamLib's ``Files.ReadsIterate`` /
``Files.Type.{FASTA, SingleEndFASTQ, PairedEndFASTQ}`` (consumed at
the reference's bin/KPopCount.ml:36-55,140-157,219-238): iterate reads from
one or more files, yielding ``(tag, segments)`` where ``segments`` is a list
of sequences (two for paired-end reads, reference ``segm_id``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import IO, Iterator, List, Sequence, Tuple

from ..utils.naming import close_if_owned, open_in


@dataclass(frozen=True)
class FastaInput:
    path: str


@dataclass(frozen=True)
class SingleEndFastqInput:
    path: str


@dataclass(frozen=True)
class PairedEndFastqInput:
    path1: str
    path2: str


ReadsInput = FastaInput | SingleEndFastqInput | PairedEndFastqInput


def iter_fasta(f: IO[str]) -> Iterator[Tuple[str, str]]:
    tag = None
    chunks: List[str] = []
    for line in f:
        line = line.rstrip("\n").rstrip("\r")
        if line.startswith(">"):
            if tag is not None:
                yield tag, "".join(chunks)
            tag = line[1:].split()[0] if len(line) > 1 else ""
            chunks = []
        elif line:
            chunks.append(line)
    if tag is not None:
        yield tag, "".join(chunks)


def iter_fastq(f: IO[str]) -> Iterator[Tuple[str, str]]:
    while True:
        header = f.readline()
        if not header:
            return
        header = header.rstrip("\n")
        if not header:
            continue
        if not header.startswith("@"):
            raise ValueError(f"malformed FASTQ header: {header!r}")
        seq = f.readline().rstrip("\n")
        plus = f.readline()
        if plus and not plus.startswith("+"):
            raise ValueError(f"malformed FASTQ separator: {plus!r}")
        f.readline()  # qualities
        yield header[1:].split()[0], seq


def iter_reads(inputs: Sequence[ReadsInput]) -> Iterator[Tuple[str, List[str]]]:
    """Iterate ``(tag, [segment...])`` across all inputs, in order."""
    for inp in inputs:
        if isinstance(inp, FastaInput):
            f = open_in(inp.path)
            try:
                for tag, seq in iter_fasta(f):
                    yield tag, [seq]
            finally:
                close_if_owned(f, inp.path)
        elif isinstance(inp, SingleEndFastqInput):
            f = open_in(inp.path)
            try:
                for tag, seq in iter_fastq(f):
                    yield tag, [seq]
            finally:
                close_if_owned(f, inp.path)
        elif isinstance(inp, PairedEndFastqInput):
            f1 = open_in(inp.path1)
            f2 = open_in(inp.path2)
            try:
                it1, it2 = iter_fastq(f1), iter_fastq(f2)
                n = 0
                _DONE = object()
                while True:
                    r1 = next(it1, _DONE)
                    r2 = next(it2, _DONE)
                    if r1 is _DONE and r2 is _DONE:
                        break
                    if r1 is _DONE or r2 is _DONE:
                        # the reference drives both segments as ONE record
                        # (bin/KPopCount.ml:36-55); files of different
                        # lengths are a file-format violation, fatal like
                        # every other one — never silently truncated
                        longer = inp.path2 if r1 is _DONE else inp.path1
                        raise ValueError(
                            f"paired-end FASTQ files do not match: "
                            f"{longer!r} still has reads after its mate "
                            f"ended at {n} pairs"
                        )
                    n += 1
                    yield r1[0], [r1[1], r2[1]]
            finally:
                close_if_owned(f1, inp.path1)
                close_if_owned(f2, inp.path2)
        else:
            raise TypeError(inp)
