"""Build the CUDA kernels of ``csrc/`` with ``nvcc`` and load them.

Each ``csrc/*.cu`` file compiles to an object by its own ``nvcc``, all
started together, and the objects link into one shared library with a plain
C interface, loaded with :mod:`ctypes` (no PyTorch headers, so the build
takes seconds).  The library lands in ``kpop_tpu_torch/_build/`` under a
name keyed by a hash of the sources and flags, and is built on first use.
A failed build raises with ``nvcc``'s output; nothing falls back.

Every C entry point takes its tensors as raw device pointers plus PyTorch's
current stream, enqueues its kernel, and returns ``cudaGetLastError()``.
:func:`launch` raises on a non-zero code and counts the launch in
:data:`LAUNCHES`, so a run can show which kernels it went through.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

_DIR = Path(__file__).resolve().parent
_CSRC = _DIR / "csrc"
_OUT = _DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint32
# the large-k vocabulary, in place of a dense table: k_lo, the cuckoo
# table's probe layout, its slots a table, seeds a1, b1, a2, b2, the sorted
# limbs {hi, lo}
_WIDE = (_I, _P, _I, _U, _U, _U, _U, _P)
# C entry point -> argument types, the stream last (csrc/*.cu)
_SIGNATURES = {
    # a, b, metric, na, nb, out, workspace, Q, T, D, feature slices, stream
    "kpop_pairwise_dist": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    # codes, B, L, k, canonical, base, lut, V, first row, rows, known
    # (count each read set's known windows), bucket (the bucketed plan),
    # index scratch, out, stream
    "kpop_count_spectra": (_P, _I, _I, _I, _I, _I, _P, _I, _I, _I, _I, _I, _P, _P, _P),
    "kpop_count_spectra_wide": (_P, _I, _I, _I, _I, _I, *_WIDE, _I, _I, _I, _I, _I, _P, _P,
                                _P),
    # codes, B, L, k, canonical, base, lut, V, twister, its row type (0
    # f32, 1 bf16), d, its row stride, normalize, slices, int workspace,
    # float workspace, out, stream
    "kpop_embedding_bag": (_P, _I, _I, _I, _I, _I, _P, _I, _P, _I, _I, _I, _I, _I, _P, _P, _P,
                           _P),
    "kpop_embedding_bag_wide": (_P, _I, _I, _I, _I, _I, *_WIDE, _I, _P, _I, _I, _I, _I, _I, _P, _P,
                                _P, _P),
    # the same four on the 2-bit wire: packed and valid bytes in place of
    # the codes (DNA, base 4)
    "kpop_count_spectra_packed": (_P, _P, _I, _I, _I, _I, _I, _P, _I, _I, _I, _I, _I, _P, _P,
                                  _P),
    "kpop_count_spectra_wide_packed": (_P, _P, _I, _I, _I, _I, _I, *_WIDE, _I, _I, _I, _I, _I,
                                       _P, _P, _P),
    "kpop_embedding_bag_packed": (_P, _P, _I, _I, _I, _I, _I, _P, _I, _P, _I, _I, _I, _I, _I, _P,
                                  _P, _P, _P),
    "kpop_embedding_bag_wide_packed": (_P, _P, _I, _I, _I, _I, _I, *_WIDE, _I, _P, _I, _I, _I, _I,
                                       _I, _P, _P, _P, _P),
    # dmat, B, N, k, stats, top, idx (int64), stream
    "kpop_row_digest": (_P, _I, _I, _I, _P, _P, _P, _P),
    # x, wire, K, ns, alpha, u, beta, v, slices, rows per slice, partials,
    # factors workspace, first block, stream
    "kpop_ca_gram": (_P, _I, _I, _I, _P, _P, _P, _P, _I, _I, _P, _P, _I, _P),
    # partials, slices, ns, beta, out, stream
    "kpop_ca_gram_finish": (_P, _I, _I, _P, _P, _P),
    # raw bytes, their int32 lengths, B, row stride, width, lint table,
    # workspace, out (int8 codes), stream
    "kpop_encode_bytes": (_P, _P, _I, _I, _I, _P, _P, _P, _P),
}

#: launches of each kernel since the last reset (set the values to 0)
LAUNCHES: dict[str, int] = dict.fromkeys(_SIGNATURES, 0)
#: seconds the last build took (0.0 when the library was already built)
BUILD_SECONDS = 0.0

_lock = threading.Lock()
_lib = None


def nvcc_path() -> str:
    """The CUDA toolkit's ``nvcc``: on ``PATH``, else under ``CUDA_HOME``."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found on PATH or under CUDA_HOME; the kernels of "
            "kpop_tpu_torch/csrc need the CUDA toolkit"
        )
    return path


def _sources() -> list[Path]:
    return sorted(_CSRC.glob("*.cu"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(_CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return _OUT / f"libkpop_torch_{h.hexdigest()[:16]}.so"


def _run(cmds: list[list[str]]) -> None:
    """Run the commands side by side; raise with the output of the first
    that fails."""
    procs = [
        subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for c in cmds
    ]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(
                "nvcc failed (exit %d): %s\n%s" % (p.returncode, " ".join(cmd), out)
            )


def _build(target: Path) -> None:
    global BUILD_SECONDS
    _OUT.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    # objects in a private directory, the library under a temporary name,
    # then a rename: a second process never loads a half-written library
    with tempfile.TemporaryDirectory(dir=_OUT) as tmpdir:
        sources = _sources()
        objs = [os.path.join(tmpdir, src.stem + ".o") for src in sources]
        nvcc = nvcc_path()
        _run([[nvcc, *NVCC_FLAGS, "-c", str(src), "-o", obj]
              for src, obj in zip(sources, objs)])
        tmp = os.path.join(tmpdir, target.name)
        _run([[nvcc, *NVCC_FLAGS[:2], "-shared", "-o", tmp, *objs]])
        os.replace(tmp, target)
    BUILD_SECONDS = time.perf_counter() - t0


def lib() -> ctypes.CDLL:
    """The kernel library, built on first use.  Processes that share the
    checkout (the ranks of one machine) build it one at a time, under a file
    lock: the first builds, the others find it built."""
    global _lib
    with _lock:
        if _lib is None:
            target = library_path()
            if not target.exists():
                _OUT.mkdir(parents=True, exist_ok=True)
                with open(_OUT / ".build.lock", "w") as lock:
                    fcntl.flock(lock, fcntl.LOCK_EX)
                    if not target.exists():
                        _build(target)
            loaded = ctypes.CDLL(str(target))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(loaded, name)
                fn.argtypes = argtypes
                fn.restype = _I
            loaded.kpop_error_string.argtypes = (_I,)
            loaded.kpop_error_string.restype = ctypes.c_char_p
            _lib = loaded
        return _lib


def launch(name: str, *args) -> None:
    """Enqueue kernel ``name`` on the current stream; raise on a CUDA error."""
    library = lib()
    err = getattr(library, name)(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"{name}: CUDA error {err} "
            f"({library.kpop_error_string(err).decode()})"
        )
    LAUNCHES[name] += 1


def check_cuda(name: str, *tensors: torch.Tensor, dtypes) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor of its dtype,
    all on one device."""
    dev = tensors[0].device
    for t, dt in zip(tensors, dtypes):
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name}: all tensors must be on one CUDA device")
        if t.dtype != dt:
            raise TypeError(f"{name}: expected {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
