#!/usr/bin/env python3
"""Peak device memory and host time of each step of a benchmark cell's
run, on a card: the corpus (vocabulary, tip genomes, twister, class
coordinates), the query pool and its read sets and strings, the port's
set-up with its warm-up batches, the window, the work count of a traced
run, the release and the check against the plain reference.

Run from the root of a checkout on a machine with a card:
``python3 tools/probe_cell_memory.py --workload mtb-reads --seed 7``.  Each
step starts from ``torch.cuda.reset_peak_memory_stats()``; its line gives
the peak of ``torch.cuda.max_memory_allocated()`` in the step, what is
still allocated after it and its seconds.  Prints one JSON line a step, the
card's name and memory, and the check's readings; also written to
``chiprun_out/probe_cell_memory.json``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from portbench import gen, harness  # noqa: E402

#: the generator's steps that the driver's set-up calls, by name
GEN_STEPS = ("Vocabulary", "clade_genomes", "twister", "class_coords", "held_out", "read_sets",
             "to_strings")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--seconds", type=float, default=5.0)
    a = p.parse_args(argv)
    steps = []

    def measured(name, fn):
        def run(*args, **kw):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            steps.append(dict(step=name, s=round(time.perf_counter() - t0, 3),
                              peak_bytes=torch.cuda.max_memory_allocated(),
                              after_bytes=torch.cuda.memory_allocated()))
            print(json.dumps(steps[-1]), flush=True)
            return out
        return run

    for name in GEN_STEPS:
        setattr(gen, name, measured(name, getattr(gen, name)))
    run = harness.load_run(a.workload, a.seed, torch.device("cuda", 0), False)
    drv = harness.driver(run.cell["driver"])
    drv._serve = measured("serve", drv._serve)  # the warm-up, then the window
    t0 = time.perf_counter()
    drv.setup(run)  # its steps measured one by one
    setup_s = time.perf_counter() - t0
    win = drv.window(run, a.seconds)
    work = measured("work", drv.work)(run)
    measured("release", drv.release)(run)
    readings = measured("check", drv.check)(run)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,memory.total",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    out = dict(workload=a.workload, seed=a.seed, card=smi, setup_s=setup_s,
               total_bytes=torch.cuda.get_device_properties(0).total_memory,
               metrics=win["metrics"], batches_in_work=len(work), readings=readings,
               steps=steps)
    text = json.dumps(out)
    print(text)
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "probe_cell_memory.json").write_text(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
