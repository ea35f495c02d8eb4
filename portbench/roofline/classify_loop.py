"""The least device time of one served batch.

Whatever route serves it, a batch needs: each twister row that its
windows hit read once (``rows`` × d × the twister's bytes an element),
the class coordinates read once (C × d f32), its bases read at 2 bits a
base (``bases`` / 4 bytes) and the ``[B, C]`` f32 distances written once;
and, in operations, a multiply and an add a twister element for each
distinct (query, row) pair that its windows hit (2 × ``pairs`` × d,
float32 outside the tensor cores: the count then the product with the
counts) plus the cross term of the distances (2 × B × C × d, at the TF32
tensor-core peak, the fastest it could be done).
"""

from ..peaks import least_seconds as _least


def least_seconds(u: dict) -> float:
    nbytes = u["rows"] * u["d"] * u["itemsize"] + u["C"] * u["d"] * 4 + u["bases"] / 4 \
        + u["B"] * u["C"] * 4
    return _least(nbytes, f32=2.0 * u["pairs"] * u["d"], tf32=2.0 * u["B"] * u["C"] * u["d"])
