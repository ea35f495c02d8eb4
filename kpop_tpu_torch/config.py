"""Device choice and float32 precision policy of the PyTorch port.

Device
------
``KPOP_PLATFORM`` is the variable the JAX package reads
(``kpop_tpu/config.py``).  ``cpu`` selects the CPU, where every kernel
wrapper runs its plain PyTorch version.  Unset, ``cuda`` or ``gpu`` selects
``cuda:0`` and raises when no card is visible: the port never moves to the
CPU on its own.

Precision
---------
Importing the package pins float32 matrix products to full float32 (no
TF32, in cuBLAS or cuDNN), the counterpart of ``Precision.HIGHEST`` in
``kpop_tpu/parallel/sharded.py``.  TF32 keeps about three decimal digits,
which the distance parity bounds cannot absorb.
"""

from __future__ import annotations

import os

import torch


torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")


def device() -> torch.device:
    """The device named by ``KPOP_PLATFORM`` (see the module docstring)."""
    platform = os.environ.get("KPOP_PLATFORM", "")
    if platform == "cpu":
        return torch.device("cpu")
    if platform not in ("", "cuda", "gpu"):
        raise ValueError(
            f"KPOP_PLATFORM={platform!r}: the PyTorch port runs on 'cpu' "
            "or 'cuda'"
        )
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; set KPOP_PLATFORM=cpu to run the "
            "port's plain PyTorch versions on the CPU"
        )
    return torch.device("cuda:0")
