"""kpop_tpu_torch.ops.pairwise against the Pallas kernel it ports,
kpop_tpu.ops.pallas_pairwise.pairwise_distances_pallas (interpret mode on
the CPU), and against the host float64 distance_rowwise.

Tolerance rtol 2e-4, atol 1e-5: the bound of tests/test_pallas.py, for f32
expansions |a|^2 + |b|^2 - 2ab summed in different orders."""

import numpy as np
import pytest
import torch

from kpop_tpu.core.matrix import NamedMatrix
from kpop_tpu.core.space import Distance, distance_rowwise
from kpop_tpu.ops.pallas_pairwise import pairwise_distances_pallas
from kpop_tpu_torch.ops.pairwise import (
    distance_tile,
    distance_tile_ref,
    pairwise_distances,
    pairwise_distances_ref,
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


def test_pairwise_matches_host_float64():
    a, b, m = inputs(3, 40, 23, 600)
    got = pairwise_distances(*map(torch.from_numpy, (a, b, m))).numpy()
    cols = [f"d{j}" for j in range(a.shape[1])]
    targets = NamedMatrix([f"t{i}" for i in range(len(b))], cols, b.astype(np.float64))
    queries = NamedMatrix([f"q{i}" for i in range(len(a))], cols, a.astype(np.float64))
    want = distance_rowwise(
        Distance.of_string("euclidean"), m.astype(np.float64), targets, queries
    ).data
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


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
