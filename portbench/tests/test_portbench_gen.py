"""The generator: a function of the seed, with sizes that the seed does
not change."""

import numpy as np
import pytest
import torch

from portbench import gen
from portbench.tests import small

CPU = torch.device("cpu")


def corpus(seed, name="sars2-lineages-k10"):
    cfg = small.config(name)
    seeds = gen.Seeds(seed, CPU)
    g = gen.clade_genomes(cfg, seeds)
    reads = gen.read_sets(g[:, 0], small.READS, seeds.torch("r"))
    return cfg, g, reads


def test_same_seed_same_inputs():
    _, g1, r1 = corpus(2**31 + 5)
    _, g2, r2 = corpus(2**31 + 5)
    assert torch.equal(g1, g2) and torch.equal(r1, r2)


def test_other_seed_other_inputs_same_sizes():
    _, g1, r1 = corpus(11)
    _, g2, r2 = corpus(12)
    assert g1.shape == g2.shape and r1.shape == r2.shape
    assert not torch.equal(g1, g2) and not torch.equal(r1, r2)


def test_read_set_shape():
    cfg, g, reads = corpus(3)
    L, rl = cfg["genome_length"], small.READS["read_len"]
    pairs = int(L * small.READS["coverage"] / (2 * rl))
    assert reads.shape == (g.shape[0], 2 * pairs * (rl + 1) - 1)
    # reads of rl bases joined by one N
    assert (reads[:, rl::rl + 1] == 4).all() and (reads[reads != 4] < 4).all()


def test_reads_come_from_their_genome():
    """Without errors, every first read is a slice of its genome and every
    second read a reverse complement of one."""
    cfg, g, _ = corpus(4)
    reads = dict(small.READS, error_rate=0.0)
    rs = gen.read_sets(g[:, 0], reads, gen.Seeds(4, CPU).torch("r"))
    rl = reads["read_len"]
    genome = "".join("ACGT"[b] for b in g[0, 0].tolist())
    rc = genome[::-1].translate(str.maketrans("ACGT", "TGCA"))
    parts = gen.to_strings(rs[:1])[0].split("N")
    half = len(parts) // 2
    assert all(len(p) == rl for p in parts)
    assert all(p in genome for p in parts[:half]) and all(p in rc for p in parts[half:])


def test_clade_tree_shape():
    parent, length, tip = gen.clade_tree(np.random.default_rng(0), 5, 4, 0.08, 0.15)
    per = 7
    assert len(parent) == 5 * per and (tip >= 0).sum() == 5 * 4
    roots = np.nonzero(parent < 0)[0]
    assert list(roots) == [c * per + per - 1 for c in range(5)]
    assert all(parent[i] > i for i in range(len(parent)) if parent[i] >= 0)
    kids = np.bincount(parent[parent >= 0], minlength=len(parent))
    assert all(kids[i] == 2 for i in range(len(parent)) if tip[i] < 0)
    assert (length > 0).all()


def test_tips_differ_by_the_tree():
    """Tips of one class share more than tips of two classes."""
    cfg = dict(small.config("sars2-lineages-k10"), genome_length=20000)
    g = gen.clade_genomes(cfg, gen.Seeds(5, CPU))
    within = (g[:, 0] != g[:, 1]).float().mean()
    between = (g[0, 0] != g[1, 0]).float().mean()
    assert 0 < within < 0.01 and within < between


@pytest.mark.parametrize("k", [3, 4, 5])
def test_vocabulary_is_every_canonical_kmer(k):
    v = gen.Vocabulary(k, CPU)
    assert v.size == (4**k + (4 ** (k // 2) if k % 2 == 0 else 0)) // 2
    assert len(set(v.names())) == v.size
