"""``kpop-classify-torch``'s serving loop: sequence strings to summary
lines.

Set-up builds the classifier around the twister already on the card
(``ops/pipeline.py::params_around_twister``) and the one-rank
``DeviceStep`` that ``cli/classify.py::serving_step`` returns.  The window
runs ``_classify``'s loop: it dispatches a batch of the traffic's
``batch`` queries (``DeviceStep.dispatch``: host encode, upload, device
step, download started), then drains the batch before it
(``DeviceStep.materialize``) and writes each row's
``core/space.py::summarize_distance_row`` line to an in-memory sink: one
batch in flight.  Queries come from a seeded pool of held-out genomes, or
of read sets drawn from them, cycled.
"""

from __future__ import annotations

import io
import time

import numpy as np
import torch

from .. import gen
from ..reference import classify as ref
from ..reference.compare import dist2_gap, line_readings, merge
from ..reference.kmers import encode, window_rows

END_TO_END = {"classify_seqs_per_s": "seqs/s", "classify_p95_ms": "ms"}
#: batches served before the window, through the window's own loop
WARM_BATCHES = 3
#: batches whose distances and lines the comparison reads
SAMPLE_BATCHES = 24
#: queries the reference counts and twists at a time
REF_QUERIES = 128


def corpus(run) -> dict:
    """The configuration's vocabulary, tip genomes, twister, inertia and
    class coordinates (the class spectra projected through the twister)."""
    cfg, seeds = run.config, run.seeds
    vocab = gen.Vocabulary(cfg["k"], run.device)
    genomes = gen.clade_genomes(cfg, seeds)
    tw = gen.twister(cfg, vocab.size, seeds)
    coords = gen.class_coords(cfg, genomes, vocab, tw)
    return dict(vocab=vocab, genomes=genomes, twister=tw, inertia=gen.inertia(cfg),
                coords=coords, class_names=["C%d" % (c + 1) for c in range(cfg["classes"])])


class Reservoir:
    """A uniform sample of at most ``size`` of the items offered, drawn
    from the seeded ``rng`` (reservoir sampling): the outputs that the
    comparison reads, whatever the number the window made."""

    def __init__(self, size: int, rng: np.random.Generator):
        self.size, self.rng, self.items, self.seen = size, rng, [], 0

    def offer(self, item) -> None:
        if len(self.items) < self.size:
            self.items.append(item)
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.size:
                self.items[j] = item
        self.seen += 1


def setup(run) -> None:
    from kpop_tpu_torch.cli.classify import DeviceStep
    from kpop_tpu_torch.core.kmers import KmerSpace
    from kpop_tpu_torch.core.space import Distance, Metric
    from kpop_tpu_torch.ops.pipeline import params_around_twister

    cfg, tr, st = run.config, run.traffic, run.state
    st.update(corpus(run))
    seeds = run.seeds
    pool, pool_cls = gen.held_out(st.pop("genomes"), cfg, tr["pool"], seeds)
    if tr.get("reads"):
        pool = gen.read_sets(pool, tr["reads"], seeds.torch("query_reads"))
    st["seqs"] = gen.to_strings(pool)
    del pool
    st["tags"] = ["q%d-C%d" % (i + 1, c + 1) for i, c in enumerate(pool_cls)]
    params = params_around_twister(
        KmerSpace(cfg["content"], cfg["k"]), st["vocab"].names(), st["twister"], st["inertia"],
        st["coords"], Distance.of_string(cfg["distance"]), Metric.of_string(cfg["metric"]),
        dtype={"f32": torch.float32, "bf16": torch.bfloat16}[cfg["dtype"]])
    st["step"] = DeviceStep(params, tr["project_path"])
    st["served"] = []
    _serve(run, batches=WARM_BATCHES)


def _serve(run, batches: int | None = None, seconds: float | None = None) -> dict:
    """``_classify``'s loop over the pool for ``batches`` batches or until
    ``seconds`` have passed; each batch's latency from its dispatch to its
    last line written."""
    from kpop_tpu_torch.core.space import summarize_distance_row

    st, rec = run.state, run.recorder
    step, seqs, tags, names = st["step"], st["seqs"], st["tags"], st["class_names"]
    B, keep, P = run.traffic["batch"], run.traffic["keep_at_most"], len(seqs)
    sink = io.StringIO()
    kept = Reservoir(SAMPLE_BATCHES, run.seeds.numpy("sample"))
    lat: list[float] = []
    counts = dict(attempted=0, lines=0)
    served: list[int] = []

    def drain(p):
        i, btags, handle, t_disp = p
        with rec.span("classify.wait"):
            dmat = step.materialize(handle)
        with rec.span("classify.format"):
            lines = [summarize_distance_row(keep, t, row, names) for t, row in zip(btags, dmat)]
            for line in lines:
                sink.write(line + "\n")
        lat.append(time.perf_counter() - t_disp)
        counts["lines"] += len(lines)
        kept.offer((i, dmat, lines))

    pending = None
    t_start = time.perf_counter()
    i = 0
    while True:
        t = time.perf_counter()
        if (batches is not None and i >= batches) or (seconds is not None and
                                                      t >= t_start + seconds):
            break
        idx = [(i * B + j) % P for j in range(B)]
        with rec.span("classify.dispatch"):
            handle = step.dispatch([seqs[j] for j in idx])
        counts["attempted"] += B
        if pending is not None:
            drain(pending)
        pending = (i, [tags[j] for j in idx], handle, t)
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
    """Each served batch's work (``roofline/classify_loop.py``): the
    distinct (query, vocabulary row) pairs its windows hit, the rows hit
    by the batch as a whole, its bases, and the sizes of the product and
    the distances."""
    st = run.state
    vocab = st["vocab"]
    B, P = run.traffic["batch"], len(st["seqs"])
    period = P // np.gcd(P, B)
    d = st["twister"].shape[1]
    item = 2 if run.config["dtype"] == "bf16" else 4
    per = {}
    for i in sorted({b % period for b in st["served"]}):
        pairs, rows, bases = 0, [], 0
        for j in ((i * B + j) % P for j in range(B)):
            codes = torch.as_tensor(encode([st["seqs"][j]]), device=run.device)
            r = window_rows(codes, vocab.k, vocab.lut, vocab.size)
            u = torch.unique(r[r < vocab.size])
            pairs += int(u.numel())
            rows.append(u)
            bases += len(st["seqs"][j])
        per[i] = dict(pairs=pairs, rows=int(torch.unique(torch.cat(rows)).numel()), bases=bases,
                      B=B, C=len(st["class_names"]), d=d, itemsize=item)
    return [per[b % period] for b in st["served"]]


def release(run) -> None:
    run.state.pop("step", None)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def _reference(run, pool: list[int], name: str) -> dict[int, np.ndarray]:
    """Distance rows of the pool's queries ``pool``, from the plain
    reference in the precision ``name``."""
    st, cfg = run.state, run.config
    vocab = st["vocab"]
    metric = torch.as_tensor(ref.metric_weights(st["inertia"], cfg["metric"]), device=run.device)
    classes = torch.as_tensor(st["coords"], device=run.device)
    out = {}
    for i in range(0, len(pool), REF_QUERIES):
        part = pool[i : i + REF_QUERIES]
        codes = torch.as_tensor(encode([st["seqs"][j] for j in part]), device=run.device)
        spectra = vocab.counts(codes)
        q = ref.twist(spectra, st["twister"], name)
        dist = ref.distances(q, classes, metric, name).double().cpu().numpy()
        out.update(zip(part, dist))
    return out


def _readings(run, outputs) -> dict:
    """The readings of ``outputs`` ([(batch, [B, C] distances, lines)])
    against the float64 reference."""
    st = run.state
    B, P, keep = run.traffic["batch"], len(st["seqs"]), run.traffic["keep_at_most"]
    names = {n: c for c, n in enumerate(st["class_names"])}
    pools = {i: [(i * B + j) % P for j in range(B)] for i, _, _ in outputs}
    rows = _reference(run, sorted({j for p in pools.values() for j in p}), "f64")
    readings = [dict(dist2_gap=0.0, rank_gap=0.0, line_gap=0.0, lines_wrong=0.0)]
    seen: dict[int, np.ndarray] = {}
    worst = (0.0,)
    repeat = 0.0
    for i, dmat, lines in outputs:
        ref_d = np.stack([rows[j] for j in pools[i]])
        if np.shape(dmat) == ref_d.shape:
            gap = np.abs(np.asarray(dmat) ** 2 - ref_d**2)
            r, c = np.unravel_index(int(gap.argmax()), gap.shape)
            if gap[r, c] > worst[0]:
                worst = (float(gap[r, c]), i, int(r), pools[i][r], int(c), float(dmat[r, c]),
                         float(ref_d[r, c]), float(np.sort(ref_d[r])[0]))
            for j, row in zip(pools[i], dmat):
                if j in seen:
                    repeat = max(repeat, float(np.abs(seen[j] - row).max()))
                seen[j] = row
        readings.append(dict(dist2_gap=dist2_gap(dmat, ref_d),
                             lines_wrong=float(abs(len(lines) - len(pools[i])))))
        for j, line in zip(pools[i], lines):
            readings.append(line_readings(st["tags"][j], line, rows[j], names, keep))
    # where the widest gap lies, and how far one query's rows differ
    # between the batches that served it (read by calibrate.py)
    st["diag"] = dict(worst=worst, repeat_gap=repeat)
    return merge(readings)


def check(run) -> dict:
    """The comparison: the kept batches' distances and lines against the
    reference's."""
    if not run.state.get("kept"):
        return {}
    return _readings(run, run.state["kept"])


def control(run, name: str = "tf32") -> dict:
    """The control's readings: the reference, computed in ``name``, put in
    the program's place for the same batches."""
    st = run.state
    B, P, keep = run.traffic["batch"], len(st["seqs"]), run.traffic["keep_at_most"]
    outputs = []
    for i, _, _ in st["kept"]:
        pool = [(i * B + j) % P for j in range(B)]
        rows = _reference(run, pool, name)
        dmat = np.stack([rows[j] for j in pool])
        lines = [ref.format_line(st["tags"][j], rows[j], st["class_names"], keep) for j in pool]
        outputs.append((i, dmat, lines))
    return _readings(run, outputs)
