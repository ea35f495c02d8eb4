"""The benchmark's one generator: genomes, read sets, twisters, class
coordinates and query pools, all made from ``--seed`` on the run's
device.

Genomes are evolved down a covid-shaped clade tree under JC69, as
``tests/data/phylo.py`` does for upstream KPop's R generators
(test/clusters-covid.R, test/clusters-tb.R): ``classes`` sibling clades off
the root, each a random binary subtree of ``tips_per_class`` tips, the
clade's own branch ``between * (0.5 + U)`` long and every other branch
``Exp(within)``; along a branch of length t a site changes with probability
3/4 (1 - exp(-4/3 rate t)), to one of the other three bases.  Read sets
are ART-shaped paired reads (phylo.py's ``sim_paired_reads``, vectorised):
fragments of N(insert_mean, insert_sd), read 1 from the fragment's 5' end,
read 2 the reverse complement of its 3' end, uniform substitution errors;
the reads joined by ``N``, all first reads then all second reads, as
``bench.py`` joins them into one record.

Everything a run makes is a function of the seed and of the device
(``torch.Generator`` streams differ between the CPU and a card); sizes
never depend on the seed.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from .reference.kmers import BASE_CHARS, canonical_codes, counts, hex_labels, lookup_table


class Seeds:
    """Independent random streams of one run, each named."""

    def __init__(self, seed: int, device: torch.device):
        self.seed = int(seed)
        self.device = device

    def _key(self, name: str) -> int:
        h = hashlib.sha256(f"{self.seed}/{name}".encode()).digest()
        return int.from_bytes(h[:8], "little") >> 1

    def torch(self, name: str) -> torch.Generator:
        g = torch.Generator(device=self.device)
        g.manual_seed(self._key(name))
        return g

    def numpy(self, name: str) -> np.random.Generator:
        return np.random.default_rng(self._key(name))


def clade_tree(rng: np.random.Generator, classes: int, tips: int, between: float,
               within: float) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The tree's nodes, class by class: ``parent [n]`` (-1 for a clade's
    root, whose parent is the tree's root), ``length [n]`` and ``tip [n]``
    (the tip's index within its class, -1 for an inner node), with every
    parent after its children within a class.  A clade's tips are merged
    two at a time, chosen at random, as phylo.py's ``random_clade_tree``."""
    per = 2 * tips - 1
    parent = np.full((classes, per), -1, dtype=np.int64)
    live = np.tile(np.arange(tips), (classes, 1))
    for new in range(tips, per):
        pick = np.argsort(rng.random(live.shape), axis=1)[:, :2]
        rows = np.arange(classes)[:, None]
        parent[rows, live[rows, pick]] = new
        keep = np.ones(live.shape, dtype=bool)
        keep[rows, pick] = False
        live = np.concatenate([live[keep].reshape(classes, -1),
                               np.full((classes, 1), new)], axis=1)
    length = rng.exponential(within, size=(classes, per))
    length[:, per - 1] = between * (0.5 + rng.random(classes))
    base = (np.arange(classes) * per)[:, None]
    flat_parent = np.where(parent >= 0, parent + base, -1).reshape(-1)
    tip = np.tile(np.where(np.arange(per) < tips, np.arange(per), -1), classes)
    return flat_parent, length.reshape(-1), tip


def mutate(seqs: torch.Tensor, p: torch.Tensor, g: torch.Generator) -> torch.Tensor:
    """Each site of ``[n, L]`` uint8 bases changed with probability ``p
    [n]`` to one of the other three bases."""
    hit = torch.rand(seqs.shape, generator=g, device=seqs.device) < p[:, None]
    shift = torch.randint(1, 4, seqs.shape, generator=g, device=seqs.device, dtype=torch.uint8)
    return torch.where(hit, (seqs + shift) % 4, seqs)


def clade_genomes(cfg: dict, seeds: Seeds, chunk: int = 1024) -> torch.Tensor:
    """``[classes, tips_per_class, genome_length]`` uint8 tip genomes of the
    configuration's clade tree (its ``tree``: between, within, rate)."""
    tree = cfg["tree"]
    C, T, L = cfg["classes"], cfg["tips_per_class"], cfg["genome_length"]
    parent, length, tip = clade_tree(seeds.numpy("tree"), C, T, tree["between"], tree["within"])
    g = seeds.torch("genomes")
    dev = seeds.device
    root = torch.randint(0, 4, (L,), generator=g, device=dev, dtype=torch.uint8)
    p = torch.as_tensor(0.75 * (1.0 - np.exp(-4.0 / 3.0 * tree["rate"] * length)),
                        dtype=torch.float32, device=dev)
    seqs = torch.empty((len(parent), L), dtype=torch.uint8, device=dev)
    depth = np.zeros(len(parent), dtype=np.int64)
    for i in range(len(parent) - 1, -1, -1):  # parents come after children
        depth[i] = 0 if parent[i] < 0 else depth[parent[i]] + 1
    for level in range(depth.max() + 1):
        nodes = np.nonzero(depth == level)[0]
        for i in range(0, len(nodes), chunk):
            at = torch.as_tensor(nodes[i : i + chunk], device=dev)
            par = parent[nodes[i : i + chunk]]
            src = (root.expand(len(at), L) if level == 0
                   else seqs[torch.as_tensor(par, device=dev)])
            seqs[at] = mutate(src, p[at], g)
    tips = np.nonzero(tip >= 0)[0]
    return seqs[torch.as_tensor(tips, device=dev)].view(C, T, L)


def read_sets(genomes: torch.Tensor, reads: dict, g: torch.Generator) -> torch.Tensor:
    """``[n, L]`` uint8 genomes -> ``[n, R]`` uint8 read sets (4 for the
    ``N`` between reads): ``reads`` gives read_len, coverage, insert_mean,
    insert_sd, error_rate; int(L coverage / (2 read_len)) pairs a genome."""
    n, L = genomes.shape
    rl = reads["read_len"]
    pairs = max(1, int(L * reads["coverage"] / (2 * rl)))
    dev = genomes.device
    frag = torch.normal(float(reads["insert_mean"]), float(reads["insert_sd"]), (n, pairs),
                        generator=g, device=dev).trunc().clamp(min=rl, max=L).long()
    start = (torch.rand((n, pairs), generator=g, device=dev) * (L - frag + 1)).long()
    start = torch.minimum(start, L - frag)
    at = torch.arange(rl, device=dev)
    fwd_idx = start[..., None] + at
    rev_idx = (start + frag - 1)[..., None] - at
    rows = torch.arange(n, device=dev)[:, None, None]
    fwd = genomes[rows, fwd_idx]
    rev = 3 - genomes[rows, rev_idx]
    both = torch.cat([fwd, rev], dim=1)  # all first reads, then all second reads
    err = torch.rand(both.shape, generator=g, device=dev) < reads["error_rate"]
    shift = torch.randint(1, 4, both.shape, generator=g, device=dev, dtype=torch.uint8)
    both = torch.where(err, (both + shift) % 4, both)
    sep = torch.full((n, both.shape[1], 1), 4, dtype=torch.uint8, device=dev)
    return torch.cat([both, sep], dim=2).view(n, -1)[:, :-1]


def to_strings(codes: torch.Tensor) -> list[str]:
    """``[n, L]`` uint8 bases (4 for N) -> strings."""
    chars = BASE_CHARS[codes.cpu().numpy()]
    return [row.tobytes().decode("ascii") for row in chars]


class Vocabulary:
    """Every canonical k-mer, in code order: the rows of the twister."""

    def __init__(self, k: int, device: torch.device):
        self.k = k
        self.codes = canonical_codes(k)
        self.size = len(self.codes)
        self.lut = torch.as_tensor(lookup_table(k, self.codes), device=device)

    def names(self) -> list[str]:
        return hex_labels(self.codes, self.k)

    def counts(self, codes: torch.Tensor, chunk: int = 8) -> torch.Tensor:
        return counts(codes, self.k, self.lut, self.size, chunk)


def twister(cfg: dict, V: int, seeds: Seeds) -> torch.Tensor:
    """``[V, d]`` f32 twister, N(0, twister_scale^2) entries, on the card:
    d = classes - 1, as a CA of the class table gives."""
    d = cfg["classes"] - 1
    return torch.randn((V, d), generator=seeds.torch("twister"), device=seeds.device,
                       dtype=torch.float32).mul_(cfg["twister_scale"])


def inertia(cfg: dict) -> np.ndarray:
    """The twister's inertia: (i + 1)^-inertia_decay for dimension i,
    summing to 1, as a CA's share of the spectrum falls with its rank."""
    x = np.arange(1, cfg["classes"], dtype=np.float64) ** -cfg["inertia_decay"]
    return x / x.sum()


def class_spectra(cfg: dict, genomes: torch.Tensor, vocab: Vocabulary, chunk: int = 16):
    """The class spectra, a block of classes at a time: yields ``[classes,
    V]`` int64 counts, the counts of each class's first ``train_tips``
    tips' genomes summed."""
    C, n = genomes.shape[0], cfg["train_tips"]
    train = genomes[:, :n].reshape(C * n, -1)
    step = max(n, chunk - chunk % n)
    for i in range(0, C * n, step):
        yield vocab.counts(train[i : i + step]).view(-1, n, vocab.size).sum(dim=1)


def project(spectra: torch.Tensor, tw: torch.Tensor) -> torch.Tensor:
    """``[n, V]`` counts -> ``[n, d]`` f32 twisted coordinates, divided by
    each spectrum's total (the class coordinates the classifier serves)."""
    s = spectra.to(torch.float32)
    sums = s.sum(dim=1, keepdim=True)
    return (s @ tw) / torch.where(sums == 0, torch.ones_like(sums), sums)


def class_coords(cfg: dict, genomes: torch.Tensor, vocab: Vocabulary,
                 tw: torch.Tensor) -> np.ndarray:
    """``[classes, d]`` float64 class coordinates: the class spectra
    projected through the twister ``tw``."""
    return torch.cat([project(block, tw) for block in
                      class_spectra(cfg, genomes, vocab)]).double().cpu().numpy()


def held_out(genomes: torch.Tensor, cfg: dict, pool: int, seeds: Seeds) -> tuple[torch.Tensor,
                                                                                  np.ndarray]:
    """``pool`` held-out tips (tips after the training ones), drawn without
    replacement: ``[pool, L]`` genomes and their class indices."""
    C, T = genomes.shape[:2]
    n = cfg["train_tips"]
    cls = np.repeat(np.arange(C), T - n)
    tipi = np.tile(np.arange(n, T), C)
    pick = seeds.numpy("pool").permutation(len(cls))[:pool]
    at = torch.as_tensor(cls[pick] * T + tipi[pick], device=genomes.device)
    return genomes.reshape(C * T, -1)[at], cls[pick]
