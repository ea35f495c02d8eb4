"""The least device time of one summarized batch, from the driver's own
count (``drivers/summarize_loop.py::work``), whatever implements it.

A batch of ``B`` query rows against ``N`` targets of width ``d`` needs:
the queries and the targets read once ((B + N) d f32), the ``[B, N]`` f32
distances written once, and the digests written once (``B (16 + 12 k)``:
4 f32 statistics, and k f32 distances with their int64 targets); in
operations, the cross term of the distances (2 B N d, at the TF32
tensor-core peak, the fastest it could be done).

The value is a :class:`Least`: a float, the batch's least seconds, that
also carries the least of its two parts, which the readers
``summarize.tile_roofline`` and ``summarize.digest_roofline`` read: the
tile (the same cross term, the rows read and the distances written once)
and the digest (the distances read once at the memory rate).
"""

from ..peaks import HBM_BYTES_PER_S
from ..peaks import least_seconds as _least


class Least(float):
    """A batch's least seconds, with its parts ``tile`` and ``digest``."""

    def __new__(cls, total: float, tile: float, digest: float):
        out = super().__new__(cls, total)
        out.tile, out.digest = tile, digest
        return out


def least_seconds(u: dict) -> Least:
    B, N, d, k = u["B"], u["N"], u["d"], u["k"]
    ops = 2.0 * B * N * d
    tile_bytes = (B + N) * d * 4 + B * N * 4
    return Least(_least(tile_bytes + B * (16 + 12 * k), tf32=ops),
                 tile=_least(tile_bytes, tf32=ops), digest=B * N * 4 / HBM_BYTES_PER_S)
