"""Run one cell of the benchmark of ``kpop_tpu_torch`` on the card.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell is ``portbench/cells/<cell>.json``.
The run makes its inputs from the seed, sets up and warms up the port,
measures for ``--seconds`` seconds, then compares what the timed path
produced with the plain reference (``portbench/reference``).  The last
line of standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the end-to-end metrics; with ``--trace 1`` the
per-layer metrics, read from ``torch.profiler``), ``device`` and, traced,
``breakdown``; last, ``checks``: each compared number beside its limit,
also printed as the last lines of standard error.  It exits with 2,
printing no result, when no card is visible, and with 3 when ``jax``,
``jaxlib``, ``flax`` or ``kpop_tpu`` was loaded.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    os.environ.setdefault("USE_FLAX", "0")
    import torch

    from . import harness

    cell = harness.load_json("cells", a.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.get("chips", 1):
        sys.stderr.write("portbench: no CUDA card, or fewer than the cell asks for\n")
        return 2
    run = harness.load_run(a.workload, a.seed, torch.device("cuda", 0), bool(a.trace), cell=cell)
    out = harness.execute(run, a.seconds, T0, on_card=True)
    found = harness.forbidden_modules()
    if found:
        sys.stderr.write("portbench: loaded in this process: %s\n" % ", ".join(found))
        return 3
    sys.stderr.write("".join("check %s %.6g limit %.6g\n" % (k, v["value"], v["limit"])
                             for k, v in out["checks"].items()))
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
