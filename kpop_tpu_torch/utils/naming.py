"""Automatic file naming, mirroring the reference's extension conventions.

Any prefix starting with ``/dev/`` bypasses extension naming so that every
stage can stream through pipes (reference: lib/KMerDB.ml:28-30,391-393,
lib/Matrix.ml:309-320).  A ``-`` prefix additionally maps to stdin/stdout.
"""

from __future__ import annotations

import sys
from typing import IO


def is_stream(prefix: str) -> bool:
    return prefix.startswith("/dev/") or prefix == "-"


def with_ext(prefix: str, ext: str) -> str:
    """``prefix -> prefix + ext`` unless prefix is a /dev/* stream."""
    if is_stream(prefix):
        return prefix
    return prefix + ext


SPECTRA_EXT = ".KPopSpectra.txt"  # lib/KMerDB.ml:26-31
COUNTER_BIN_EXT = ".KPopCounter"  # lib/KMerDB.ml:391-393
COUNTER_TABLE_EXT = ".KPopCounter.txt"  # lib/KMerDB.ml:1001-1003
TWISTER_BIN_EXT = ".KPopTwister"  # lib/Twister.ml:219-221
SUMMARY_EXT = ".KPopSummary.txt"  # lib/Matrix.ml:318-320
SPLITS_BIN_EXT = ".PhyloSplits"
SPLITS_TABLE_EXT = ".PhyloSplits.txt"


def open_in(path: str) -> IO[str]:
    if path == "-" or path == "/dev/stdin":
        return sys.stdin
    if path.endswith(".gz"):
        # transparent gzip input: every real-world reference workflow feeds
        # gzipped FASTQ (README.md:693-699, via zcat pipes) — accept the
        # file directly as well
        import gzip

        return gzip.open(path, "rt")
    return open(path, "r")


def open_out(path: str) -> IO[str]:
    if path == "-" or path == "/dev/stdout":
        return sys.stdout
    if path == "/dev/stderr":
        return sys.stderr
    return open(path, "w")


def open_in_bin(path: str) -> IO[bytes]:
    if path == "-" or path == "/dev/stdin":
        return sys.stdin.buffer
    if path.endswith(".gz"):
        import gzip

        return gzip.open(path, "rb")
    return open(path, "rb")


def open_out_bin(path: str) -> IO[bytes]:
    if path == "-" or path == "/dev/stdout":
        return sys.stdout.buffer
    if path == "/dev/stderr":
        return sys.stderr.buffer
    return open(path, "wb")


def close_if_owned(f, path: str) -> None:
    if path not in ("-", "/dev/stdin", "/dev/stdout", "/dev/stderr"):
        f.close()
    else:
        f.flush()
