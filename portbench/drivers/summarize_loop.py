"""``kpop-twistdb-torch -s``'s relatedness engine: twisted query rows to
summary lines.

Set-up builds the lineage classifier's class coordinates as
``classify_loop.corpus`` does and frees the twister (``-s`` holds only the
twisted database on the card), makes the configuration's ``queries``
twisted rows on the host in float64 (:func:`twisted_rows`), as
``Test.KPopTwisted`` is read into memory, and builds one ``SummaryStep``
(``kpop_tpu_torch/ops/summaries.py``) over the coordinates.  The window
runs ``summarize_rowwise_device``'s loop: it dispatches a batch of the
traffic's ``batch`` rows, in order over the queries and wrapping around,
then drains the batch before it (``SummaryStep.materialize``) and writes
its lines to an in-memory sink: one batch in flight.
"""

from __future__ import annotations

import io
import math
import time

import numpy as np
import torch

from ..reference import classify as ref
from ..reference.compare import line_readings, merge
from . import classify_loop
from .classify_loop import Reservoir

END_TO_END = {"classify_seqs_per_s": "seqs/s", "classify_p95_ms": "ms"}
#: batches served before the window, through the window's own loop
WARM_BATCHES = 3
#: batches whose lines the comparison reads
SAMPLE_BATCHES = 24
#: query rows made on the device at a time
GEN_ROWS = 32768
#: query rows the reference compares with the classes at a time
REF_ROWS = 1024


def twisted_rows(coords: np.ndarray, rows: int, noise: float, seeds) -> tuple[np.ndarray,
                                                                               np.ndarray]:
    """``rows`` float64 twisted query rows on the host and each row's
    lineage: a lineage drawn from the seed, its coordinates ``c`` plus
    N(0, (noise |c|)^2 / d) noise a column, made on the run's device
    ``GEN_ROWS`` rows at a time."""
    dev = seeds.device
    c = torch.as_tensor(coords, dtype=torch.float64, device=dev)
    C, d = c.shape
    sd = noise * torch.linalg.vector_norm(c, dim=1) / math.sqrt(d)
    g = seeds.torch("queries")
    lineage = torch.randint(0, C, (rows,), generator=g, device=dev)
    out = np.empty((rows, d))
    host = torch.from_numpy(out)
    for lo in range(0, rows, GEN_ROWS):
        at = lineage[lo : lo + GEN_ROWS]
        x = torch.randn((len(at), d), generator=g, dtype=torch.float64, device=dev)
        host[lo : lo + len(at)].copy_(x.mul_(sd[at, None]).add_(c[at]))
    return out, lineage.cpu().numpy()


def setup(run) -> None:
    # first, so that a port without the step stops before any work
    from kpop_tpu_torch.ops.summaries import SummaryStep
    from kpop_tpu_torch.core.matrix import NamedMatrix
    from kpop_tpu_torch.core.space import Distance, Metric

    cfg, tr, st = run.config, run.traffic, run.state
    corpus = classify_loop.corpus(run)
    st.update(coords=corpus["coords"], inertia=corpus["inertia"],
              class_names=corpus["class_names"])
    del corpus  # the twister, genomes and vocabulary
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    st["queries"], lineage = twisted_rows(st["coords"], cfg["queries"], cfg["query_noise"],
                                          run.seeds)
    st["names"] = ["q%d-C%d" % (i + 1, c + 1) for i, c in enumerate(lineage.tolist())]
    d = st["coords"].shape[1]
    targets = NamedMatrix(st["class_names"], ["D%d" % (j + 1) for j in range(d)], st["coords"])
    metric = Metric.of_string(cfg["metric"]).compute(st["inertia"])
    st["step"] = SummaryStep(Distance.of_string(cfg["distance"]), metric, targets,
                             tr["keep_at_most"], cfg["distance_normalize"], tr["backend"],
                             batch=tr["batch"])
    _serve(run, batches=WARM_BATCHES)


def rows_of(run, i: int) -> np.ndarray:
    """The query rows of batch ``i``: ``batch`` rows in order from ``i *
    batch``, wrapping around."""
    B, P = run.traffic["batch"], run.config["queries"]
    return (i * B + np.arange(B)) % P


def _serve(run, batches: int | None = None, seconds: float | None = None) -> dict:
    """The engine's loop over the queries for ``batches`` batches or until
    ``seconds`` have passed; each batch's latency from its dispatch to its
    last line written."""
    st, rec = run.state, run.recorder
    step, queries, names = st["step"], st["queries"], st["names"]
    B, P = run.traffic["batch"], len(names)
    sink = io.StringIO()
    kept = Reservoir(SAMPLE_BATCHES, run.seeds.numpy("sample"))
    lat: list[float] = []
    counts = dict(attempted=0, lines=0)
    served: list[int] = []

    def drain(p):
        i, handle, t_disp = p
        with rec.span("classify.wait"):
            text = step.materialize(handle)
        with rec.span("classify.format"):
            sink.write(text)
        lat.append(time.perf_counter() - t_disp)
        counts["lines"] += text.count("\n")
        kept.offer((i, text))

    pending = None
    t_start = time.perf_counter()
    i = 0
    while True:
        t = time.perf_counter()
        if (batches is not None and i >= batches) or (seconds is not None and
                                                      t >= t_start + seconds):
            break
        lo = i * B % P
        with rec.span("classify.dispatch"):
            if lo + B <= P:
                handle = step.dispatch(queries[lo : lo + B], names[lo : lo + B])
            else:  # the pass's last batch wraps around
                at = rows_of(run, i)
                handle = step.dispatch(queries[at], [names[j] for j in at])
        counts["attempted"] += B
        if pending is not None:
            drain(pending)
        pending = (i, handle, t)
        served.append(i)
        i += 1
    if pending is not None:
        drain(pending)
    elapsed = time.perf_counter() - t_start
    return dict(lat=lat, elapsed=elapsed, kept=kept.items, served=served, **counts)


def window(run, seconds: float) -> dict:
    out = _serve(run, seconds=seconds)
    st = run.state
    st["kept"], st["served"] = out["kept"], out["served"]
    return dict(metrics={"classify_seqs_per_s": out["lines"] / out["elapsed"],
                         "classify_p95_ms": float(np.percentile(out["lat"], 95)) * 1e3},
                attempted=out["attempted"], failed=out["attempted"] - out["lines"])


def work(run) -> list[dict]:
    """Each served batch's work (``roofline/summarize_loop.py``): its rows
    ``B``, the targets ``N``, the width ``d`` and the nearest targets a
    line lists at least, ``k``."""
    st = run.state
    N, d = st["coords"].shape
    unit = dict(B=run.traffic["batch"], N=N, d=d, k=run.traffic["keep_at_most"])
    return [unit] * len(st["served"])


def release(run) -> None:
    run.state.pop("step", None)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def _reference(run, rows: list[int], name: str) -> dict[int, np.ndarray]:
    """Distance rows of the query rows ``rows`` to the classes, from the
    plain reference in the precision ``name`` (each row divided by its own
    weighted norm: the configuration's ``distance_normalize``)."""
    st, cfg = run.state, run.config
    metric = torch.as_tensor(ref.metric_weights(st["inertia"], cfg["metric"]), device=run.device)
    classes = torch.as_tensor(st["coords"], device=run.device)
    out = {}
    for i in range(0, len(rows), REF_ROWS):
        part = rows[i : i + REF_ROWS]
        q = torch.as_tensor(st["queries"][part], device=run.device)
        out.update(zip(part, ref.distances(q, classes, metric, name).double().cpu().numpy()))
    return out


def _readings(run, outputs) -> dict:
    """The readings of ``outputs`` ([(batch, its lines as one string)])
    against the float64 reference."""
    st = run.state
    keep, B = run.traffic["keep_at_most"], run.traffic["batch"]
    classes = {n: c for c, n in enumerate(st["class_names"])}
    at = {i: rows_of(run, i).tolist() for i, _ in outputs}
    ref_rows = _reference(run, sorted({j for js in at.values() for j in js}), "f64")
    readings = [dict(rank_gap=0.0, line_gap=0.0, lines_wrong=0.0)]
    for i, text in outputs:
        lines = text.split("\n")
        if lines[-1] == "":
            lines.pop()
        readings.append(dict(lines_wrong=float(abs(len(lines) - B))))
        for j, line in zip(at[i], lines):
            readings.append(line_readings(st["names"][j], line, ref_rows[j], classes, keep))
    return merge(readings)


def check(run) -> dict:
    """The comparison: the kept batches' lines against the reference's
    distances."""
    if not run.state.get("kept"):
        return {}
    return _readings(run, run.state["kept"])


def control(run, name: str = "tf32") -> dict:
    """The control's readings: the reference, computed in ``name``, put in
    the program's place for the same batches (``format_line``)."""
    st = run.state
    keep = run.traffic["keep_at_most"]
    outputs = []
    for i, _ in st["kept"]:
        at = rows_of(run, i).tolist()
        rows = _reference(run, at, name)
        outputs.append((i, "".join(ref.format_line(st["names"][j], rows[j], st["class_names"],
                                                   keep) + "\n" for j in at)))
    return _readings(run, outputs)
