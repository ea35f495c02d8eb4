"""Readings for the limits: the program's and the control's compared
numbers on many seeds, in one process (the benchmark's runs do not run
this).

    python3 -m portbench.calibrate --workload <cell> --seeds 11,12,... --seconds 3
        [--control] [--out readings.jsonl]

For each seed: set-up, a short window at the cell's own load, the
program's readings (``check``), with ``--control`` the control's readings
(the driver's ``control``: the reference in the precision below the one
the configuration states, put in the program's place), then the program's state freed.  One JSON line a
seed.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--control", action="store_true")
    p.add_argument("--out", default="")
    a = p.parse_args(argv)
    import torch

    from . import harness

    if not torch.cuda.is_available():
        sys.stderr.write("calibrate: no CUDA card\n")
        return 2
    drv = None
    for seed in (int(s) for s in a.seeds.split(",")):
        t0 = time.perf_counter()
        run = harness.load_run(a.workload, seed, torch.device("cuda", 0), False)
        drv = harness.driver(run.cell["driver"])
        drv.setup(run)
        setup_s = time.perf_counter() - t0
        win = drv.window(run, a.seconds)
        line = dict(workload=a.workload, seed=seed, setup_s=setup_s, metrics=win["metrics"],
                    attempted=win["attempted"], failed=win["failed"])
        if a.control:
            line["control"] = drv.control(run)
            line["control_diag"] = run.state.get("diag")
        drv.release(run)
        line["program"] = drv.check(run)
        line["diag"] = run.state.get("diag")
        text = json.dumps(line)
        print(text, flush=True)
        if a.out:
            with open(a.out, "a") as f:
                f.write(text + "\n")
        del run
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
