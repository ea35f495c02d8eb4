"""The plain reference against the port at small sizes on the CPU (the
test imports the port; the reference does not)."""

import numpy as np
import pytest
import torch

from kpop_tpu_torch.core.kmers import KmerSpace
from kpop_tpu_torch.core.space import Distance, Metric, summarize_distance_row
from kpop_tpu_torch.ops.encode import encode_reads_host
from kpop_tpu_torch.ops.pipeline import (count_spectra, distances_to_classes,
                                         params_around_twister, project)
from portbench import gen
from portbench.reference import classify
from portbench.reference.compare import line_readings
from portbench.reference.kmers import encode
from portbench.tests import small

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def served():
    cfg = small.config("sars2-lineages-k10")
    seeds = gen.Seeds(9, CPU)
    g = gen.clade_genomes(cfg, seeds)
    vocab = gen.Vocabulary(cfg["k"], CPU)
    tw = gen.twister(cfg, vocab.size, seeds)
    coords = gen.class_coords(cfg, g, vocab, tw)
    queries = gen.to_strings(gen.read_sets(g[:, 1], small.READS, seeds.torch("q")))
    inertia = gen.inertia(cfg)
    params = params_around_twister(KmerSpace("DNA-ds", cfg["k"]), vocab.names(), tw, inertia,
                                   coords, Distance.of_string("euclidean"),
                                   Metric.of_string(cfg["metric"]))
    return cfg, vocab, tw, coords, queries, inertia, params


def test_encode(served):
    queries = served[4]
    assert np.array_equal(encode(queries), encode_reads_host(queries))


def test_counts(served):
    cfg, vocab, _, _, queries, _, params = served
    ref = vocab.counts(torch.as_tensor(encode(queries)))
    prog = count_spectra(params, torch.as_tensor(encode_reads_host(queries)))
    assert torch.equal(ref.float(), prog)


def test_metric(served):
    cfg, inertia = served[0], served[5]
    for spec in ("powers(1,1,2)", "flat", "powers(2,0.5,1)"):
        assert np.allclose(classify.metric_weights(inertia, spec),
                           Metric.of_string(spec).compute(inertia), rtol=1e-14)


def test_distances_and_lines(served):
    cfg, vocab, tw, coords, queries, inertia, params = served
    codes = torch.as_tensor(encode_reads_host(queries))
    prog = distances_to_classes(params, project(params, count_spectra(params, codes))).double()
    metric = torch.as_tensor(classify.metric_weights(inertia, cfg["metric"]))
    spectra = vocab.counts(torch.as_tensor(encode(queries)))
    ref = classify.distances(classify.twist(spectra, tw), torch.as_tensor(coords), metric)
    assert torch.allclose(prog, ref, atol=1e-5)
    names = ["C%d" % (c + 1) for c in range(len(coords))]
    index = {n: i for i, n in enumerate(names)}
    for i, row in enumerate(prog.numpy()):
        line = summarize_distance_row(2, "q%d" % i, row, names)
        ours = classify.format_line("q%d" % i, row, names, 2)
        assert line == ours
        r = line_readings("q%d" % i, line, ref[i].numpy(), index, 2)
        assert r["lines_wrong"] == 0 and r["line_gap"] < 1e-4 and r["rank_gap"] < 1e-5
