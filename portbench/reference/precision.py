"""The precision a reference computation runs in."""

from __future__ import annotations

import contextlib

import torch

#: name -> torch dtype; "tf32" is float32 with TF32 products on the card
DTYPES = {"f64": torch.float64, "f32": torch.float32, "tf32": torch.float32}


@contextlib.contextmanager
def precision(name: str):
    """Run the block in ``name`` ("f64", "f32" or "tf32"): TF32 products
    only for "tf32", and the previous settings restored after.  Yields
    the dtype."""
    mm, dnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = name == "tf32"
    torch.backends.cudnn.allow_tf32 = name == "tf32"
    try:
        yield DTYPES[name]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = dnn
