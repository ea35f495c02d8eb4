"""kpop_tpu_torch: the PyTorch + CUDA port of kpop-tpu's serving path and
relatedness engine.

It runs ``kpop-classify``'s device step (window codes, vocabulary lookup,
spectrum counting or the embedding bag, the twister projection, distances
to the classes and the digest) and the device backends of
``kpop-twistdb -s/-d`` and ``kpop-countdb --distances`` (distance blocks
and row digests) on one NVIDIA Hopper card.  The counting, embedding-bag,
distance-tile and row-digest steps are CUDA kernels written for
``sm_90a`` (``csrc/``), built with ``nvcc`` on first use
(:mod:`kpop_tpu_torch._build`).  Each has a plain PyTorch version beside
it, which runs for tensors on the CPU.

The package imports no JAX.  It shares the JAX-free host modules of
``kpop_tpu`` (``core``, ``io``, ``utils``, ``native``); the JAX package
stays the reference the port is tested against.
"""

from . import config  # noqa: F401  (pins float32 matmul precision)

__version__ = "0.1.0"
