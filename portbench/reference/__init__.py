"""The plain reference of the benchmark: NumPy and PyTorch alone.

Nothing here imports ``jax``, ``kpop_tpu`` or ``kpop_tpu_torch``: every
vocabulary, count, metric, projection, distance and summary is worked
out again from the benchmark's own inputs, so that the
program's outputs can be judged against it (``compare.py``).
"""
