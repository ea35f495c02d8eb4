#!/usr/bin/env python3
"""Same-call probe of the serving step's encode on a card, each step alone:
the host encode of the "codes" wire and its pinned copy
(``encode_reads_host`` + ``pin_memory``), the bytes wire's ring staging
(``ByteRing.reserve`` + ``fill``), and the card's lint and encode
(``encode_bytes``, ``csrc/encode_bytes.cu``) beside its plain PyTorch
version on the card and its bound.

Run from the root of a checkout on a machine with a card:
``python3 tools/probe_encode.py``.  Two batches of 64 ASCII strings, as the
benchmark's cells serve them: read sets of 601,885 bases (``N`` joins, 1 %
of them in dash runs with ``--dashes``) and genomes of 29,903.  Host steps
are the median of ``--reps`` runs (ms), in turns codes, ring, ring, codes;
the kernel and the plain version by CUDA events over ``--launches``
launches, and each of the kernel's three stages by ``torch.profiler``.
Prints one JSON object, also written to ``chiprun_out/probe_encode.json``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from kpop_tpu_torch.core.kmers import _DNA_CODE  # noqa: E402
from kpop_tpu_torch.ops.encode import (  # noqa: E402
    ByteRing,
    encode_bytes,
    encode_bytes_ref,
    encode_reads_host,
)

#: H100 SXM memory rate (NVIDIA's data sheet), as chip_smoke.py's bound
HBM_BYTES_PER_S = 3.35e12


def batch(rng, B: int, L: int, dashes: bool) -> list[str]:
    letters = np.frombuffer(b"ACGT", dtype=np.uint8)
    out = []
    for _ in range(B):
        raw = letters[rng.integers(0, 4, size=L)]
        raw[rng.integers(0, L, size=L // 300)] = ord("N")
        if dashes:
            for at in rng.integers(0, L, size=L // 800):
                raw[at: at + 8] = ord("-")
        out.append(raw.tobytes().decode())
    return out


def host_ms(fn, reps: int) -> list[float]:
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def card_ms(fn, launches: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(launches):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / launches


def kernel_stages(fn, calls: int = 20) -> dict:
    """Device ms a call of each of the encode's three kernels, by
    ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        for name in ("encode_count", "encode_scan", "encode_write"):
            if name in ev.key:
                out[name] = out.get(name, 0.0) + ev.device_time_total / 1e3 / calls
    return out


def probe(seqs: list[str], reps: int, launches: int) -> dict:
    dev = torch.device("cuda")

    def codes_wire():
        return torch.from_numpy(encode_reads_host(seqs)).pin_memory()

    ring = ByteRing(pinned=True)

    def ring_wire():
        staged = ring.reserve(seqs)
        ring.fill(staged)
        return staged

    codes_ms, ring_ms = [], []
    for _ in range(2):  # codes, ring, ring, codes
        codes_ms += host_ms(codes_wire, reps)
        ring_ms += host_ms(ring_wire, 2 * reps)
        codes_ms += host_ms(codes_wire, reps)
    staged = ring_wire()
    sent = staged.buffer.to(dev)
    table = torch.from_numpy(_DNA_CODE).to(dev)
    width = staged.longest
    rows, lengths = staged.split(sent)
    got = encode_bytes(rows, lengths, width, table)
    want = torch.from_numpy(encode_reads_host(seqs)).to(dev)
    equal = bool(torch.equal(got[:, : want.shape[1]], want)) and bool(
        (got[:, want.shape[1]:] == -1).all())
    B = len(seqs)
    read = int(lengths.sum())
    bound_ms = (read + B * width) / HBM_BYTES_PER_S * 1e3
    kernel = card_ms(lambda: encode_bytes(rows, lengths, width, table), launches)
    stages = kernel_stages(lambda: encode_bytes(rows, lengths, width, table))
    plain = card_ms(lambda: encode_bytes_ref(rows, lengths, width, table), max(launches // 50, 3))
    codes = codes_wire()
    upload_codes = card_ms(lambda: codes.to(dev, non_blocking=True), launches)
    upload_bytes = card_ms(lambda: staged.buffer.to(dev, non_blocking=True), launches)
    return dict(
        batch=[B, width], bytes_read=read, codes_equal_to_host=equal,
        host_encode_and_pin_ms=statistics.median(codes_ms), host_encode_and_pin_runs=codes_ms,
        ring_staging_ms=statistics.median(ring_ms), ring_staging_runs=ring_ms,
        kernel_ms=kernel, kernel_stages_ms=stages, bound_ms=bound_ms,
        roofline_pct=100 * bound_ms / kernel,
        plain_ms=plain, upload_codes_ms=upload_codes, upload_bytes_ms=upload_bytes,
        upload_bytes=staged.buffer.nbytes,
    )


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--launches", type=int, default=200)
    p.add_argument("--dashes", action="store_true")
    p.add_argument("--seed", type=int, default=2718281903)
    a = p.parse_args()
    if not torch.cuda.is_available():
        sys.exit("probe_encode: needs a CUDA card")
    rng = np.random.default_rng(a.seed)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    out = {"card": card.strip(), "torch": torch.__version__}
    for name, (B, L) in {"read_sets": (64, 601_885), "genomes": (64, 29_903)}.items():
        out[name] = probe(batch(rng, B, L, a.dashes), a.reps, a.launches)
    text = json.dumps(out, indent=1)
    print(text)
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "probe_encode.json").write_text(text)


if __name__ == "__main__":
    main()
