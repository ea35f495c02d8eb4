"""kpop_tpu_torch: the PyTorch + CUDA port of kpop-tpu's training, serving
path and relatedness engine.

It trains the twister on the device (``kpop-twist --backend jax``: the CA
Gram of the standardized residual and the twister product,
:mod:`kpop_tpu_torch.parallel.sharded`), runs ``kpop-classify``'s device
step (window codes, vocabulary lookup, spectrum counting or the embedding
bag, the twister projection, distances to the classes and the digest) and
the device backends of ``kpop-twistdb -s/-d`` and ``kpop-countdb
--distances`` (distance blocks and row digests) on one NVIDIA Hopper card.
The CA Gram, counting, embedding-bag, distance-tile and row-digest steps
are CUDA kernels written for ``sm_90a`` (``csrc/``), built with ``nvcc``
on first use (:mod:`kpop_tpu_torch._build`).  Each has a plain PyTorch
version beside it, which runs for tensors on the CPU.

The package imports nothing of JAX or of ``kpop_tpu``: it keeps its own
copies of the host modules (``core``, ``io``, ``utils``, ``native``) under
the same names; the JAX package stays the reference the port is tested
against.
"""

from . import config  # noqa: F401  (pins float32 matmul precision)

__version__ = "0.1.0"
