"""kpop_tpu_torch.ops.pairwise against the Pallas kernel it ports,
kpop_tpu.ops.pallas_pairwise.pairwise_distances_pallas (interpret mode on
the CPU), and against the host float64 distance_rowwise.

Tolerance rtol 2e-4, atol 1e-5: the bound of tests/test_pallas.py, for f32
expansions |a|^2 + |b|^2 - 2ab summed in different orders.

The CUDA kernel (csrc/pairwise.cu) runs only on the card; here its
arithmetic is emulated in plain torch: the split-TF32 cross term
(cvt.rna.tf32.f32 on the int32 view) and the split-K plan of its grid."""

import numpy as np
import pytest
import torch

from kpop_tpu.core.matrix import NamedMatrix
from kpop_tpu.core.space import Distance, distance_rowwise
from kpop_tpu.ops.pallas_pairwise import pairwise_distances_pallas
from kpop_tpu_torch.ops.pairwise import (
    SPLIT_UNIT,
    TILE,
    distance_tile,
    distance_tile_ref,
    pairwise_distances,
    pairwise_distances_ref,
    row_norms,
    split_plan,
    tile_grid,
)

RTOL, ATOL = 2e-4, 1e-5


def inputs(seed, Q, T, D):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((Q, D)).astype(np.float32)
    b = rng.standard_normal((T, D)).astype(np.float32)
    m = rng.random(D).astype(np.float32)
    m /= m.sum()
    a[0] = 0.0  # a zero row: its norm 0 is replaced by 1
    return a, b, m


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize(
    "Q,T,D",
    [(70, 33, 19), (5, 130, 64), (129, 65, 700), (33, 17, 1100)],
)
def test_pairwise_matches_pallas(Q, T, D, normalize):
    a, b, m = inputs(Q + T + D, Q, T, D)
    want = np.asarray(
        pairwise_distances_pallas(a, b, m, normalize=normalize, interpret=True)
    )
    ta, tb, tm = map(torch.from_numpy, (a, b, m))
    for fn in (pairwise_distances, pairwise_distances_ref):
        got = fn(ta, tb, tm, normalize=normalize)
        assert got.shape == (Q, T) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def host_float64(a, b, m):
    """distance_rowwise in float64, rows of ``a`` against rows of ``b``."""
    cols = [f"d{j}" for j in range(a.shape[1])]
    targets = NamedMatrix([f"t{i}" for i in range(len(b))], cols, b.astype(np.float64))
    queries = NamedMatrix([f"q{i}" for i in range(len(a))], cols, a.astype(np.float64))
    return distance_rowwise(
        Distance.of_string("euclidean"), m.astype(np.float64), targets, queries
    ).data


def test_pairwise_matches_host_float64():
    a, b, m = inputs(3, 40, 23, 600)
    got = pairwise_distances(*map(torch.from_numpy, (a, b, m))).numpy()
    np.testing.assert_allclose(got, host_float64(a, b, m), rtol=RTOL, atol=ATOL)


def test_distance_tile_takes_given_norms():
    """The tile scales rows by the norms it is given, which is how
    distances_to_classes passes the class norms of the parameters."""
    a, b, m = inputs(4, 9, 6, 20)
    rng = np.random.default_rng(5)
    na = rng.random(9).astype(np.float32) + 0.5
    nb = rng.random(6).astype(np.float32) + 0.5
    got = distance_tile(*map(torch.from_numpy, (a, b, m, na, nb))).numpy()
    diff = a[:, None, :] / na[:, None, None] - b[None, :, :] / nb[None, :, None]
    want = np.sqrt((diff.astype(np.float64) ** 2 * m).sum(-1))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    ref = distance_tile_ref(*map(torch.from_numpy, (a, b, m, na, nb))).numpy()
    np.testing.assert_array_equal(got, ref)


def test_distance_tile_rejects_bad_shapes():
    a = torch.zeros((4, 3))
    with pytest.raises(ValueError):
        distance_tile(a, torch.zeros((2, 4)), torch.ones(3), torch.ones(4), torch.ones(2))
    with pytest.raises(ValueError):
        distance_tile(a, torch.zeros((2, 3)), torch.ones(3), torch.ones(3), torch.ones(2))


# ---------------- the kernel's arithmetic, emulated ----------------------


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32 on the int32 view: round to nearest, ties away
    from zero, keeping 10 mantissa bits (the low 13 bits cleared)."""
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_split(x: torch.Tensor):
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def split_tf32_tile(a, b, m, na, nb, bounds=None, single=False):
    """The kernel's arithmetic: per feature slice (``bounds``, one slice
    by default), the cross term ``lo_a hi_b + hi_a lo_b + hi_a hi_b`` of
    ``a m`` and ``b`` split into TF32 halves, summed over the slices in
    order, with the row norms and the scales in the epilogue.  With
    ``single`` the cross term is one TF32 product ``hi_a hi_b``."""
    am = a * m
    bounds = bounds or [0, a.shape[1]]
    cross = torch.zeros(a.shape[0], b.shape[0])
    for f0, f1 in zip(bounds, bounds[1:]):
        ah, al = tf32_split(am[:, f0:f1])
        bh, bl = tf32_split(b[:, f0:f1])
        cross = cross + (ah @ bh.T if single else al @ bh.T + ah @ bl.T + ah @ bh.T)
    na2 = (m * a * a).sum(dim=1) / (na * na)
    nb2 = (m * b * b).sum(dim=1) / (nb * nb)
    d2 = na2[:, None] + nb2[None, :] - 2.0 * cross * (1.0 / na)[:, None] * (1.0 / nb)[None, :]
    return torch.sqrt(torch.clamp(d2, min=0.0))


def normalized_args(a, b, m):
    ta, tb, tm = map(torch.from_numpy, (a, b, m))
    return ta, tb, tm, row_norms(ta, tm), row_norms(tb, tm)


def test_tf32_rna_split():
    rng = np.random.default_rng(11)
    x = (rng.standard_normal(20_000) * 10.0 ** rng.integers(-20, 20, 20_000)).astype(np.float32)
    hi, lo = tf32_split(torch.from_numpy(x))
    for part in (hi, lo):
        assert not (part.view(torch.int32) & 0x1FFF).any()
    resid = np.abs(x.astype(np.float64) - hi.double().numpy() - lo.double().numpy())
    assert (resid <= 2.0**-22 * np.abs(x)).all()
    # ties go away from zero, on both signs; below a tie rounds down
    tie = np.float32(1.0 + 2.0**-11)
    ties = torch.tensor([tie, -tie, np.nextafter(tie, np.float32(0))], dtype=torch.float32)
    np.testing.assert_array_equal(
        tf32_rna(ties).numpy(), np.float32([1.0 + 2.0**-10, -(1.0 + 2.0**-10), 1.0])
    )


@pytest.mark.parametrize("Q,T,D", [(70, 33, 19), (129, 65, 700), (33, 17, 1100)])
def test_split_tf32_matches_host_float64(Q, T, D):
    a, b, m = inputs(Q * T + D, Q, T, D)
    got = split_tf32_tile(*normalized_args(a, b, m)).numpy()
    np.testing.assert_allclose(got, host_float64(a, b, m), rtol=RTOL, atol=ATOL)


def test_split_tf32_near_duplicates():
    """Rows that differ by about 1e-3: d^2 cancels in the expansion, so even
    the f32 plain version misses atol 1e-5.  The split stays within 4x of
    its error to float64; a single TF32 product is more than 10x worse."""
    Q, D = 32, 1100
    rng = np.random.default_rng(0)
    a = rng.standard_normal((Q, D)).astype(np.float32)
    b = (a + 1e-3 * rng.standard_normal((Q, D))).astype(np.float32)
    m = rng.random(D).astype(np.float32)
    m /= m.sum()
    args = normalized_args(a, b, m)
    want = host_float64(a, b, m)

    def err(d):
        return float(np.abs(d.double().numpy() - want).max())

    e_ref = err(distance_tile_ref(*args))
    e_split = err(split_tf32_tile(*args))
    e_tf32 = err(split_tf32_tile(*args, single=True))
    assert e_ref > ATOL
    assert e_split <= 4.0 * e_ref, (e_split, e_ref)
    assert e_tf32 > 10.0 * e_ref, (e_tf32, e_ref)


# ---------------- the split-K plan and the grid --------------------------

SHAPES = {
    "serving": (128, 512, 511),
    "relatedness": (4096, 4096, 512),
    "raw spectra": (512, 512, 367_987),
}


@pytest.mark.parametrize(
    "Q,T,D",
    [*SHAPES.values(), (70, 33, 19), (1, 1, 1), (5, 130, 0), (3, 3, 9), (129, 65, 700)],
)
def test_split_plan_covers_every_feature_once(Q, T, D):
    bounds = split_plan(Q, T, D)
    assert bounds[0] == 0 and bounds[-1] == D
    covered = np.concatenate([np.arange(f0, f1) for f0, f1 in zip(bounds, bounds[1:])])
    np.testing.assert_array_equal(covered, np.arange(D))
    if D:
        assert all(f1 > f0 for f0, f1 in zip(bounds, bounds[1:]))
    assert all(f % SPLIT_UNIT == 0 for f in bounds[:-1])


@pytest.mark.parametrize("name", list(SHAPES))
def test_split_plan_fills_one_wave(name):
    Q, T, D = SHAPES[name]
    S = len(split_plan(Q, T, D)) - 1
    blocks = -(-Q // TILE) * -(-T // TILE) * S
    assert blocks >= 128
    assert S == 1 or blocks <= 132


@pytest.mark.parametrize("Q,T,D", [(70, 33, 19), (129, 65, 700), (33, 17, 1100)])
def test_split_plan_sum_matches_plain(Q, T, D):
    """The slices' partial cross terms summed in the plan's order give the
    plain version's distances."""
    bounds = split_plan(Q, T, D)
    assert len(bounds) > 2
    a, b, m = inputs(Q + 2 * T + D, Q, T, D)
    args = normalized_args(a, b, m)
    got = split_tf32_tile(*args, bounds=bounds)
    np.testing.assert_allclose(
        got.numpy(), distance_tile_ref(*args).numpy(), rtol=RTOL, atol=ATOL
    )


def test_tile_grid():
    assert tile_grid(4096, 128) == (32, 1)
    assert tile_grid(128, 4096) == (32, 1)
    big = 65535 * TILE
    assert tile_grid(big, big) == (65535, 65535)
    assert tile_grid(2**31 - 1 - big, big) == (-(-(2**31 - 1 - big) // TILE), 65535)
    with pytest.raises(ValueError):
        tile_grid(big + 1, big + 1)
    with pytest.raises(ValueError):
        tile_grid(2**31 - big, big)
