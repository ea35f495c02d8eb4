"""The benchmark of ``kpop_tpu_torch`` on one H100: see ``run.py``."""
