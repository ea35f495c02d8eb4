"""Streaming binary serialization for kpop-tpu objects.

The reference marshals OCaml values with a magic string + archive version
("2022-04-03") in front (lib/KMerDB.ml:389-430, lib/Matrix.ml:812-845).  We
cannot (and must not) read OCaml marshal blobs; instead we define our own
framed format with the same contract: a magic tag, a version, then payload.

Crucially the format is *stream-friendly*: it can be written to and read from
non-seekable pipes (``/dev/stdout`` | ``/dev/stdin``), which the reference
relies on for workflow composition (e.g. README.md:93).

Wire layout (little-endian):

    b"KPOPTPU1"                      8-byte magic
    u32 header_len ; header JSON     {"tag": ..., "version": ..., meta...}
    repeated frames, each:
        u32 name_len ; name utf-8
        u32 json_len ; {"dtype": "<f4", "shape": [..]}
        u64 data_len ; raw array bytes (C order)
    terminator frame: name_len == 0xFFFFFFFF
"""

from __future__ import annotations

import json
import struct
from typing import IO, Dict

import numpy as np

MAGIC = b"KPOPTPU1"
ARCHIVE_VERSION = "2026-08-17"
_TERM = 0xFFFFFFFF


class IncompatibleArchive(ValueError):
    pass


def _read_exact(f: IO[bytes], n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = f.read(n - len(buf))
        if not chunk:
            raise EOFError("truncated kpop-tpu archive")
        buf += chunk
    return buf


def write_header(f: IO[bytes], tag: str, meta: Dict | None = None) -> None:
    header = {"tag": tag, "version": ARCHIVE_VERSION}
    if meta:
        header.update(meta)
    hj = json.dumps(header).encode()
    f.write(MAGIC)
    f.write(struct.pack("<I", len(hj)))
    f.write(hj)


def read_header(f: IO[bytes], expect_tag: str | None = None) -> Dict:
    magic = _read_exact(f, len(MAGIC))
    if magic != MAGIC:
        raise IncompatibleArchive(f"bad magic {magic!r}")
    (hlen,) = struct.unpack("<I", _read_exact(f, 4))
    header = json.loads(_read_exact(f, hlen))
    if header.get("version") != ARCHIVE_VERSION:
        raise IncompatibleArchive(
            f"archive version {header.get('version')!r} != {ARCHIVE_VERSION!r}"
        )
    if expect_tag is not None and header.get("tag") != expect_tag:
        raise IncompatibleArchive(
            f"expected tag {expect_tag!r}, found {header.get('tag')!r}"
        )
    return header


def write_array(f: IO[bytes], name: str, arr: np.ndarray) -> None:
    arr = np.ascontiguousarray(arr)
    nb = name.encode()
    aj = json.dumps({"dtype": arr.dtype.str, "shape": list(arr.shape)}).encode()
    f.write(struct.pack("<I", len(nb)))
    f.write(nb)
    f.write(struct.pack("<I", len(aj)))
    f.write(aj)
    data = arr.tobytes()
    f.write(struct.pack("<Q", len(data)))
    f.write(data)


def write_strings(f: IO[bytes], name: str, strings) -> None:
    """Store a list of strings as a \\x00-joined utf-8 u1 array."""
    payload = "\x00".join(strings).encode() if len(strings) else b""
    arr = np.frombuffer(payload, dtype=np.uint8)
    write_array(f, "str:" + name, arr)
    # empty-list vs [""] disambiguation
    write_array(f, "len:" + name, np.array([len(strings)], dtype=np.int64))


def write_terminator(f: IO[bytes]) -> None:
    f.write(struct.pack("<I", _TERM))


def read_frames(f: IO[bytes]) -> Dict[str, np.ndarray]:
    """Read frames until the terminator; returns {name: array}."""
    out: Dict[str, np.ndarray] = {}
    while True:
        (nlen,) = struct.unpack("<I", _read_exact(f, 4))
        if nlen == _TERM:
            break
        name = _read_exact(f, nlen).decode()
        (jlen,) = struct.unpack("<I", _read_exact(f, 4))
        spec = json.loads(_read_exact(f, jlen))
        (dlen,) = struct.unpack("<Q", _read_exact(f, 8))
        data = _read_exact(f, dlen)
        out[name] = np.frombuffer(data, dtype=np.dtype(spec["dtype"])).reshape(
            spec["shape"]
        )
    return out


def iter_frames_meta(f: IO[bytes]):
    """Yield ``(name, dtype, shape, data_offset)`` for each frame WITHOUT
    reading payloads (seeks past them) — the index pass of shard-local
    checkpoint loading.  Requires a seekable stream; piped register I/O
    keeps using :func:`read_frames`."""
    while True:
        (nlen,) = struct.unpack("<I", _read_exact(f, 4))
        if nlen == _TERM:
            return
        name = _read_exact(f, nlen).decode()
        (jlen,) = struct.unpack("<I", _read_exact(f, 4))
        spec = json.loads(_read_exact(f, jlen))
        (dlen,) = struct.unpack("<Q", _read_exact(f, 8))
        off = f.tell()
        f.seek(dlen, 1)
        yield name, np.dtype(spec["dtype"]), tuple(spec["shape"]), off


def strings_of_frames(frames: Dict[str, np.ndarray], name: str) -> list[str]:
    n = int(frames["len:" + name][0])
    if n == 0:
        return []
    payload = frames["str:" + name].tobytes().decode()
    parts = payload.split("\x00")
    if len(parts) != n:
        raise IncompatibleArchive(f"string table {name!r}: {len(parts)} != {n}")
    return parts
