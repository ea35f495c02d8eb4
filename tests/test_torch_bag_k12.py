"""The bag route at upstream's SARS-CoV-2 lineage classifier's k = 12
(``portbench/configs/sars2-lineages-k12.json``): ``DeviceStep(params,
"bag")`` from strings to summary lines, held to the benchmark's plain
reference (``portbench/reference``: int64 counts, then the float64
product in blocks of vocabulary rows) within the cell's limits.

On the CPU (the plain versions): k = 12 over a vocabulary of the corpus's
own canonical 12-mers, d = 135 (one full column block of the kernel's 128
and one of 7), six lineages of 2,000 bases whose clade tree's rate is
raised so that they differ at a few % of their sites, a seeded random
twister; the distances and lines within the cell's limits.

On a card (``python3 -m pytest tests/test_torch_bag_k12.py -q -m card``):
the configuration's widths, V = 8,390,656 and d = 1,635 (a 54.9 GB f32
twister), and a batch of 64 held-out genomes of 29,903 bases: the bag
torch.equal in its staged and gather regimes (each forced by a build with
its cut moved) and to the regime it takes, within the bag's tolerances of
its plain version (``pipeline.project_reads_ref``), and its distances
within the cell's limits of the plain reference.  This file imports nothing of JAX.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from kpop_tpu_torch import _build
from kpop_tpu_torch.cli.classify import DeviceStep, pick_path
from kpop_tpu_torch.core.kmers import KmerSpace
from kpop_tpu_torch.core.space import Distance, Metric, summarize_distance_row
from kpop_tpu_torch.ops import pipeline as tp
from portbench import gen, harness
from portbench.reference import classify as ref
from portbench.reference import kmers
from portbench.reference.compare import dist2_gap, line_readings, merge, verdict

K = 12
CELL = harness.load_json("cells", "sars2-k12-genomes")
#: sizes a CPU test holds: six lineages of 2,000 bases, d = 135, the tree's
#: rate raised 5x so that the lineages differ at a few % of their sites
SMALL = dict(classes=6, genome_length=2000, twister_scale=1.0,
             tree=dict(between=0.08, within=0.15, rate=0.05))
D_SMALL = 135
#: the bag against its plain version (chip_smoke.py's BAG_RTOL, BAG_ATOL,
#: there on a twister of scale 1)
BAG_RTOL, BAG_ATOL = 1e-5, 1e-6


def small_config() -> dict:
    return dict(harness.load_json("configs", CELL["config"]), **SMALL)


def canonical_window_codes(codes: torch.Tensor) -> torch.Tensor:
    """The canonical codes of the valid windows of ``[n, L]`` base codes."""
    ident = torch.arange(4**K, dtype=torch.int64)
    rows = kmers.window_rows(codes, K, ident, 4**K)
    return rows[rows < 4**K]


@pytest.fixture(scope="module")
def corpus():
    """The lineages' genomes on the CPU, the vocabulary of their own
    canonical 12-mers, a seeded twister, the class coordinates and the
    port's parameters around them."""
    cfg = small_config()
    seeds = gen.Seeds(2**31 + 1212, torch.device("cpu"))
    genomes = gen.clade_genomes(cfg, seeds)
    every = genomes.reshape(-1, cfg["genome_length"]).to(torch.int8)
    vocab_codes = torch.unique(canonical_window_codes(every)).numpy()
    V = len(vocab_codes)
    lut = torch.as_tensor(kmers.lookup_table(K, vocab_codes))
    g = torch.Generator().manual_seed(1212)
    tw = torch.randn((V, D_SMALL), generator=g)
    inertia = gen.inertia(dict(cfg, classes=D_SMALL + 1))
    train = genomes[:, 0].to(torch.int8)
    coords = gen.project(kmers.counts(train, K, lut, V), tw).double().numpy()
    params = tp.params_around_twister(
        KmerSpace(cfg["content"], K), kmers.hex_labels(vocab_codes, K), tw, inertia, coords,
        Distance.of_string(cfg["distance"]), Metric.of_string(cfg["metric"]))
    # held-out genomes only: a training genome lies at distance 0 from its
    # class, where a float32 distance reads up to about 1e-3 (PERF.md §2),
    # which moves the mean of a row of six classes by 270 times what it
    # does over the cell's 1,636
    queries, cls = gen.held_out(genomes, cfg, cfg["classes"], seeds)
    seqs = gen.to_strings(queries)
    tags = ["q%d-C%d" % (i + 1, c + 1) for i, c in enumerate(cls)]
    return SimpleNamespace(cfg=cfg, V=V, lut=lut, tw=tw, inertia=inertia, coords=coords,
                           params=params, seqs=seqs, tags=tags,
                           names=["C%d" % (c + 1) for c in range(cfg["classes"])])


def reference_rows(c) -> np.ndarray:
    """The plain reference's float64 distance rows of the queries."""
    spectra = kmers.counts(torch.as_tensor(kmers.encode(c.seqs)), K, c.lut, c.V)
    metric = torch.as_tensor(ref.metric_weights(c.inertia, c.cfg["metric"]))
    q = ref.twist(spectra, c.tw, "f64")
    return ref.distances(q, torch.as_tensor(c.coords), metric, "f64").numpy()


def test_bag_step_within_the_cells_limits(corpus):
    c = corpus
    step = DeviceStep(c.params, "bag")
    dmat = step.materialize(step.dispatch(c.seqs))
    assert step.path == "bag" and dmat.shape == (len(c.seqs), len(c.names))
    keep = harness.load_json("traffic", CELL["traffic"])["keep_at_most"]
    lines = [summarize_distance_row(keep, t, row, c.names) for t, row in zip(c.tags, dmat)]
    rows = reference_rows(c)
    names = {n: i for i, n in enumerate(c.names)}
    readings = merge([dict(dist2_gap=dist2_gap(dmat, rows), lines_wrong=0.0)]
                     + [line_readings(t, line, row, names, keep)
                        for t, line, row in zip(c.tags, lines, rows)])
    ok, checks = verdict(readings, CELL["limits"])
    assert ok, checks


def test_pick_path_takes_dense_at_the_cell():
    """At the cell's batch (64 genomes of 29,892 windows, V = 8,390,656,
    d = 1,635) ``pick_path``'s TPU constants reckon the bag at 200.2 GB and
    the dense route at 61.3 GB, so ``auto`` takes the dense route, and the
    cell's traffic names the bag."""
    assert pick_path(64, 29_892, 8_390_656, 1_635) == "dense"
    assert harness.load_json("traffic", CELL["traffic"])["project_path"] == "bag"


# ---------------- on a card -------------------------------------------------


@pytest.fixture
def card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the bag kernel runs only there")
    monkeypatch.setenv("KPOP_PLATFORM", "cuda")
    return torch.device("cuda", 0)


def forced(monkeypatch, tile_entries: int):
    """The kernels built with the bag's regime cut at ``tile_entries``: 0
    takes the staged regime always, 2^30 the gather."""
    monkeypatch.setattr(tp, "BAG_GATHER_TILE_ENTRIES", tile_entries)
    monkeypatch.setattr(_build, "_lib", None)


@pytest.mark.card
def test_bag_at_the_configurations_widths(card, monkeypatch):
    cfg = harness.load_json("configs", CELL["config"])
    seeds = gen.Seeds(2**31 + 2323, card)
    vocab = gen.Vocabulary(K, card)
    genomes = gen.clade_genomes(cfg, seeds)
    tw = gen.twister(cfg, vocab.size, seeds)
    assert tw.shape == (8_390_656, 1_635) and tw.nbytes == 54_874_890_240
    coords = gen.class_coords(cfg, genomes, vocab, tw)
    queries, _ = gen.held_out(genomes, cfg, 64, seeds)
    del genomes
    codes = queries.to(torch.int8)
    lut = torch.cat([vocab.lut, torch.tensor([vocab.size], device=card)]).to(torch.int32)
    inertia = gen.inertia(cfg)
    params = tp.assemble_params(KmerSpace(cfg["content"], K), dict(vocab_lut=lut), tw, inertia,
                                coords, Distance.of_string(cfg["distance"]),
                                Metric.of_string(cfg["metric"]), device=card)
    taken = tp.project_reads(params, codes)
    bags = []
    for cut in (0, 2**30):  # staged, then gather
        forced(monkeypatch, cut)
        bags.append(tp.project_reads(params, codes))
    monkeypatch.undo()
    assert torch.equal(bags[0], bags[1]) and torch.equal(taken, bags[0])
    # the plain bag: chip_smoke.py's tolerances, the absolute one at the
    # twister's scale
    plain = tp.project_reads_ref(params, codes)
    assert torch.allclose(taken, plain, rtol=BAG_RTOL, atol=BAG_ATOL * cfg["twister_scale"])
    # the distances against the plain reference, computed in blocks
    dmat = tp.distances_to_classes(params, taken).double().cpu().numpy()
    metric = torch.as_tensor(ref.metric_weights(inertia, cfg["metric"]), device=card)
    q = ref.twist(vocab.counts(codes), tw, "f64")
    want = ref.distances(q, torch.as_tensor(coords, device=card), metric, "f64").cpu().numpy()
    assert dist2_gap(dmat, want) <= CELL["limits"]["dist2_gap"]
