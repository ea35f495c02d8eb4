"""Dense named matrices with KPop type tags and text/binary I/O.

TPU-first re-design of the reference's matrix layer (lib/Matrix.ml:271-345 for
the typed wrapper, BiOCamLib ``Matrix`` for the base container): the payload is
a single contiguous numpy array (promoted to a ``jax.Array`` inside kernels)
instead of an array of per-row ``Float.Array``s, and parallel text I/O is
replaced by bulk numpy parsing.

Text format (e.g. ``.KPopTwisted.txt``, reference README.md:618-624):

    ""\t"Dim1"\t"Dim2"...
    "sample1"\t0.46...\t0.56...

Names are double-quoted; numbers are printed with ``%.15g`` by default.
The reader also accepts the unquoted and ``rn``-headed variants produced by
R's ``data.table::fwrite`` in the reference pipeline (src/KPopTwist:100-116).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field, replace
from typing import IO, List

import numpy as np

from ..io import framed
from ..utils.naming import (
    close_if_owned,
    open_in,
    open_in_bin,
    open_out,
    open_out_bin,
    with_ext,
)
from ..utils.quoting import quote, strip_external_quotes_and_check


class MatrixType(enum.Enum):
    """KPop matrix type tags (reference lib/Matrix.ml:273-301)."""

    DISTILL = "KPopDistill"
    TWISTER = "KPopTwister"
    INERTIA = "KPopInertia"
    METRICS = "KPopMetrics"
    TWISTED = "KPopTwisted"
    VECTORS = "KPopVectors"
    DMATRIX = "KPopDMatrix"

    def table_filename(self, prefix: str) -> str:
        return with_ext(prefix, "." + self.value + ".txt")

    def binary_filename(self, prefix: str) -> str:
        # Twister/Inertia binaries always travel as a .KPopTwister pair
        # (lib/Matrix.ml:312-317)
        assert self not in (MatrixType.TWISTER, MatrixType.INERTIA)
        return with_ext(prefix, "." + self.value)


class UnexpectedType(TypeError):
    def __init__(self, found: MatrixType, expected: MatrixType):
        super().__init__(f"expected {expected.value}, found {found.value}")
        self.found, self.expected = found, expected


class IncompatibleGeometries(ValueError):
    pass


class DuplicateRowName(ValueError):
    pass


@dataclass
class NamedMatrix:
    """A dense float matrix with row and column names."""

    row_names: List[str]
    col_names: List[str]
    data: np.ndarray  # shape [n_rows, n_cols]

    def __post_init__(self):
        self.data = np.asarray(self.data)
        if self.data.size == 0:
            self.data = self.data.reshape(len(self.row_names), len(self.col_names))
        assert self.data.shape == (len(self.row_names), len(self.col_names)), (
            self.data.shape,
            len(self.row_names),
            len(self.col_names),
        )

    @classmethod
    def empty(cls) -> "NamedMatrix":
        return cls([], [], np.zeros((0, 0)))

    @property
    def n_rows(self) -> int:
        return len(self.row_names)

    @property
    def n_cols(self) -> int:
        return len(self.col_names)

    def transpose(self) -> "NamedMatrix":
        return NamedMatrix(list(self.col_names), list(self.row_names), self.data.T)

    def merge_rowwise(self, other: "NamedMatrix") -> "NamedMatrix":
        """Row-wise concatenation; geometries (col names) must match.

        Implements the ``-a``/``-A`` accumulate semantics of the reference
        (bin/KPopTwistDB.ml:162-189, lib/Matrix.ml:331-334).
        """
        if self.n_rows == 0 and self.n_cols == 0:
            return other
        if other.n_rows == 0 and other.n_cols == 0:
            return self
        if self.col_names != other.col_names:
            raise IncompatibleGeometries(self.col_names, other.col_names)
        dup = set(self.row_names) & set(other.row_names)
        if dup:
            raise DuplicateRowName(sorted(dup)[0])
        return NamedMatrix(
            self.row_names + other.row_names,
            list(self.col_names),
            np.concatenate([self.data, other.data], axis=0),
        )

    # ---------------- text I/O ----------------

    def write_text(self, f: IO[str], precision: int = 15) -> None:
        fmt = "%.{}g".format(precision)
        f.write("\t".join([quote("")] + [quote(c) for c in self.col_names]) + "\n")
        data = np.asarray(self.data)
        try:
            from .. import native
        except Exception:
            native = None
        if native is not None and native.available() and self.n_rows:
            # row-blocked native formatting (quoted names as row prefixes)
            R = max(1, (32 << 20) // max(1, self.n_cols * 24))
            for r0 in range(0, self.n_rows, R):
                rows = slice(r0, min(r0 + R, self.n_rows))
                f.write(
                    native.format_tsv(
                        data[rows],
                        precision,
                        [quote(rn) for rn in self.row_names[rows]],
                    ).decode("utf-8", "surrogateescape")
                )
            return
        for i, rn in enumerate(self.row_names):
            row = data[i]
            f.write(quote(rn))
            for v in row:
                f.write("\t" + fmt % v)
            f.write("\n")

    @classmethod
    def _parse_body_native(cls, raw_bytes: bytes, header) -> "NamedMatrix | None":
        """Fast path for the TSV body: threaded C float parsing
        (native.parse_tsv_body) instead of a per-cell ``float()`` loop.
        Returns None whenever the tolerant Python reader should run
        instead (no native lib, malformed/ragged lines)."""
        if not raw_bytes:
            return None
        try:
            from .. import native
        except Exception:
            return None
        if not native.available():
            return None
        raw = np.frombuffer(raw_bytes, dtype=np.uint8)
        nl = np.flatnonzero(raw == 10)
        starts = np.concatenate([[0], nl + 1])
        ends = np.concatenate([nl, [len(raw)]])
        keep = ends > starts
        starts, ends = starts[keep], ends[keep]
        if len(starts) == 0:
            return None
        n_cols = raw_bytes[starts[0] : ends[0]].count(b"\t")
        res = native.parse_tsv_body(raw_bytes, starts, ends, n_cols)
        if res is None:
            return None
        vals, names = res
        row_names = [strip_external_quotes_and_check(n) for n in names]
        if len(header) == n_cols + 1:
            col_names = [strip_external_quotes_and_check(c) for c in header[1:]]
        elif len(header) == n_cols:
            col_names = [strip_external_quotes_and_check(c) for c in header]
        else:
            raise IncompatibleGeometries(
                f"header has {len(header)} fields for {n_cols} data columns"
            )
        return cls(row_names, col_names, vals)

    @classmethod
    def read_text(cls, f: IO[str]) -> "NamedMatrix":
        # Read bytes straight off the underlying buffer when there is one
        # (regular files, pipes): skips the utf-8 text layer entirely, so
        # the native body parser sees the mmap-sized byte run with zero
        # str<->bytes round trips.  Only safe on a FRESH stream: once the
        # text layer has read anything it holds look-ahead bytes that
        # buffer.read() would silently skip, so seekable streams must be
        # at position 0 and unseekable ones (pipes: tell() raises) fall
        # through to the text path.  StringIO and exotic streams take the
        # text path below too.
        buf = getattr(f, "buffer", None)
        if buf is not None:
            try:
                fresh = f.tell() == 0
            except (OSError, ValueError):
                fresh = False
            raw_all = None
            if fresh:
                try:
                    raw_all = buf.read()
                except Exception:
                    raw_all = None
            if raw_all is not None:
                if raw_all == b"":
                    return cls.empty()
                cut = raw_all.find(b"\n")
                header_b = raw_all[:cut] if cut >= 0 else raw_all
                if header_b.endswith(b"\r"):
                    # CRLF file: the text layer used to translate \r\n;
                    # the bytes path normalizes once so the body parsers
                    # (native and Python) see plain LF lines
                    raw_all = raw_all.replace(b"\r\n", b"\n")
                    cut = raw_all.find(b"\n")
                    header_b = raw_all[:cut] if cut >= 0 else raw_all
                header = header_b.decode().split("\t")
                body_b = raw_all[cut + 1 :] if cut >= 0 else b""
                fast = cls._parse_body_native(body_b, header)
                if fast is not None:
                    return fast
                return cls._read_body_python(
                    body_b.decode(), header
                )
        header_line = f.readline()
        if header_line == "":
            return cls.empty()
        header = header_line.rstrip("\n").split("\t")
        body = f.read()
        try:
            body_b = body.encode("ascii")
        except UnicodeEncodeError:
            body_b = None
        if body_b is not None:
            fast = cls._parse_body_native(body_b, header)
            if fast is not None:
                return fast
        return cls._read_body_python(body, header)

    @classmethod
    def _read_body_python(cls, body: str, header) -> "NamedMatrix":
        row_names: List[str] = []
        rows: List[np.ndarray] = []
        n_cols = None
        for line in body.split("\n"):
            parts = line.split("\t")
            if parts == [""]:
                continue
            row_names.append(strip_external_quotes_and_check(parts[0]))
            vals = np.array([float(x.strip('"')) for x in parts[1:]])
            if n_cols is None:
                n_cols = len(vals)
            elif len(vals) != n_cols:
                raise IncompatibleGeometries(
                    f"row {parts[0]!r} has {len(vals)} values, expected {n_cols}"
                )
            rows.append(vals)
        if n_cols is None:
            n_cols = len(header) - 1 if len(header) > 1 else 0
        # Header may or may not carry a leading dummy cell ("" or "rn").
        if len(header) == n_cols + 1:
            col_names = [strip_external_quotes_and_check(c) for c in header[1:]]
        elif len(header) == n_cols:
            col_names = [strip_external_quotes_and_check(c) for c in header]
        else:
            raise IncompatibleGeometries(
                f"header has {len(header)} fields for {n_cols} data columns"
            )
        data = (
            np.stack(rows, axis=0)
            if rows
            else np.zeros((0, n_cols))
        )
        return cls(row_names, col_names, data)

    # ---------------- binary I/O (frames, no header) ----------------

    def write_frames(self, f: IO[bytes]) -> None:
        framed.write_strings(f, "row_names", self.row_names)
        framed.write_strings(f, "col_names", self.col_names)
        framed.write_array(f, "data", np.asarray(self.data, dtype=np.float64))
        framed.write_terminator(f)

    @classmethod
    def read_frames(cls, f: IO[bytes]) -> "NamedMatrix":
        frames = framed.read_frames(f)
        return cls(
            framed.strings_of_frames(frames, "row_names"),
            framed.strings_of_frames(frames, "col_names"),
            frames["data"],
        )


@dataclass
class KPopMatrix:
    """A :class:`NamedMatrix` tagged with a KPop type (lib/Matrix.ml:302-305)."""

    which: MatrixType
    matrix: NamedMatrix = field(default_factory=NamedMatrix.empty)

    def expect(self, ty: MatrixType) -> "KPopMatrix":
        if self.which != ty:
            raise UnexpectedType(self.which, ty)
        return self

    def transpose(self) -> "KPopMatrix":
        return replace(self, matrix=self.matrix.transpose())

    def merge_rowwise(self, other: "KPopMatrix") -> "KPopMatrix":
        if self.which != other.which:
            raise UnexpectedType(other.which, self.which)
        return replace(self, matrix=self.matrix.merge_rowwise(other.matrix))

    # -------- typed file I/O with automatic naming --------

    def to_table(self, prefix: str, precision: int = 15) -> None:
        path = self.which.table_filename(prefix)
        f = open_out(path)
        try:
            self.matrix.write_text(f, precision=precision)
        finally:
            close_if_owned(f, path)

    @classmethod
    def of_table(cls, which: MatrixType, prefix: str) -> "KPopMatrix":
        path = which.table_filename(prefix)
        f = open_in(path)
        try:
            return cls(which, NamedMatrix.read_text(f))
        finally:
            close_if_owned(f, path)

    def to_binary(self, prefix: str) -> None:
        path = self.which.binary_filename(prefix)
        f = open_out_bin(path)
        try:
            framed.write_header(f, self.which.value)
            self.matrix.write_frames(f)
        finally:
            close_if_owned(f, path)

    @classmethod
    def of_binary(cls, which: MatrixType, prefix: str) -> "KPopMatrix":
        path = which.binary_filename(prefix)
        f = open_in_bin(path)
        try:
            framed.read_header(f, expect_tag=which.value)
            return cls(which, NamedMatrix.read_frames(f))
        finally:
            close_if_owned(f, path)
