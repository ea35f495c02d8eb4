"""The embedding-bag kernel of kpop_tpu_torch (csrc/embedding_bag.cu),
emulated on the CPU stage by stage, against the plain version
project_reads_ref and the JAX package's project_reads.

The kernel runs only on the card.  Its order is emulated here: read sets in
groups of BAG_GROUP; known windows bucketed by vocabulary tile of R rows
(the kernel's BAG_COUNTERS counters a tile and its atomic slot claims leave
any order within a tile, so the keys are shuffled there); the tiles that
hold keys cut into S slices of near-equal keys plus tiles; per tile exact
integer counts, rows walked in index order and count x row (one f32
product, one f32 add) added to each read set that hit the row; the
slices summed in order, then divided by the known count.  R is the
package's BAG_TILE_ROWS and S comes from its own plan, bag_plan.

Tolerance: rtol 1e-5, atol 1e-6 against the plain version and JAX (the
bag's bound in chip_smoke.py): count x row rounds once where a plain sum
adds the row count times, and the slices sum in another order.  The
integer counts equal count_spectra_ref exactly."""

import dataclasses
import math

import numpy as np
import pytest
import torch

from kpop_tpu.ops import pipeline as jp
from kpop_tpu_torch.ops import pipeline as tp
from kpop_tpu_torch.ops.pairwise import H100_SMS

from test_torch_pipeline import both_params, codes_of, trained  # noqa: F401

BAG_RTOL, BAG_ATOL = 1e-5, 1e-6
K = 5


def slice_starts(kbase, S):
    """The kernel's slices of the n tiles that hold keys (key offsets
    ``kbase``, n + 1 of them): slice s starts at the least j with
    (kbase[j] + M j) S >= s (N + M n), N the keys and M their mean a tile."""
    n, N = len(kbase) - 1, int(kbase[-1])
    M = max(1, N // n) if n else 1
    cost = np.asarray(kbase, dtype=np.int64) + M * np.arange(n + 1)
    starts = np.searchsorted(cost * S, np.arange(S + 1) * (N + M * n), side="left")
    assert starts[0] == 0 and starts[-1] == n and (np.diff(starts) >= 0).all()
    return starts


def emulate_bag(params, codes, normalize=True, n_sm=H100_SMS, seed=0):
    """The kernel's stages in numpy: returns the ``[B, d]`` bag and the
    ``[B, V]`` integer counts of its tiles.  ``seed`` shuffles the keys
    within each tile, as the scatter's atomics may."""
    rng = np.random.default_rng(seed)
    V, d = params.twister.shape
    tw = params.twister.float().numpy()  # a bf16 row widened, exactly
    idx = tp.vocab_lookup(params, codes).numpy()
    B = idx.shape[0]
    R, S = tp.BAG_TILE_ROWS, tp.bag_plan(V, d, n_sm)
    T = -(-V // R)
    out = np.empty((B, d), dtype=np.float32)
    counts = np.zeros((B, V), dtype=np.int64)
    for g0 in range(0, B, tp.BAG_GROUP):
        grp = idx[g0 : g0 + tp.BAG_GROUP]
        Bg = grp.shape[0]
        # 1. bucket: tile histogram, exclusive offsets, keys by tile
        b_of, w_of = np.nonzero(grp < V)
        rows = grp[b_of, w_of]
        perm = rng.permutation(len(rows))
        order = perm[np.argsort(rows[perm] // R, kind="stable")]
        rows, b_of = rows[order], b_of[order]
        off = np.concatenate([[0], np.cumsum(np.bincount(rows // R, minlength=T))])
        N = int(off[-1])
        # the tiles that hold keys, their key offsets and the slices
        nz = np.nonzero(np.diff(off))[0]
        starts = slice_starts(np.append(off[nz], N), S)
        # 2. accumulate each slice
        ws = np.zeros((S, Bg, d), dtype=np.float32)
        for s in range(S):
            acc = ws[s]
            for t in nz[starts[s] : starts[s + 1]]:
                k0, k1 = off[t], off[t + 1]
                cnt = np.zeros((R, Bg), dtype=np.int64)
                np.add.at(cnt, (rows[k0:k1] - t * R, b_of[k0:k1]), 1)
                n_rows = min(R, V - t * R)
                counts[g0 : g0 + Bg, t * R : t * R + n_rows] += cnt[:n_rows].T
                for r in range(R):
                    bs = np.nonzero(cnt[r])[0]
                    if len(bs):
                        x = cnt[r, bs].astype(np.float32)[:, None] * tw[t * R + r][None, :]
                        acc[bs] = acc[bs] + x
        # 3. the slices in order, then the known counts
        total = ws[0].copy()
        for s in range(1, S):
            total = total + ws[s]
        if normalize:
            known = (grp < V).sum(axis=1)
            total = total / np.maximum(known, 1).astype(np.float32)[:, None]
        out[g0 : g0 + Bg] = total
    return out, counts


def gather_sequences(tiles, S_starts, nz, Bg):
    """bag_gather's walk of one slice's tiles, for each warp's 4 read sets:
    lane 4 g + q reads the entry range of read set 4 w + q in tile jg + g
    (GATHER_TILES = 8 tiles a step), the 32 lanes' ranges are flattened by
    a prefix sum over the lanes, and entry i is found in the range of the
    first lane whose running total exceeds it.  ``tiles[t][b]`` lists the
    (row, count) entries of read set b in tile t in row order.  Returns,
    for each read set, the entries in the order the kernel adds them."""
    seq = {b: [] for b in range(Bg)}
    for w in range(-(-Bg // 4)):
        for jg in range(S_starts[0], S_starts[1], 8):
            ranges = []
            for lane in range(32):
                g, q = divmod(lane, 4)
                j, b = jg + g, 4 * w + q
                ranges.append(tiles[nz[j]][b] if j < S_starts[1] and b < Bg else [])
            incl = np.cumsum([len(r) for r in ranges])
            for i in range(int(incl[-1]) if len(incl) else 0):
                owner = int(np.searchsorted(incl, i, side="right"))  # first incl > i
                first = incl[owner] - len(ranges[owner])
                seq[4 * w + owner % 4].append(ranges[owner][i - first])
    return seq


def test_gather_adds_each_read_set_in_the_staged_order():
    """bag_gather and bag_accumulate add count x row to each read set in
    the same (tile, row) order, so the two regimes give the same bits; a
    slice of tiles holding 0 to 9 entries a read set, read sets past the
    group's end empty."""
    rng = np.random.default_rng(11)
    Bg, n_tiles = 45, 29
    nz = np.arange(n_tiles) * 3
    tiles = {}
    for t in nz:
        tiles[t] = {}
        for b in range(Bg):
            rows = np.sort(rng.choice(tp.BAG_TILE_ROWS, size=int(rng.integers(0, 10)), replace=False))
            tiles[t][b] = [(int(r), int(rng.integers(1, 5))) for r in rows]
    for lo, hi in ((0, n_tiles), (3, 20), (7, 7)):
        seq = gather_sequences(tiles, (lo, hi), nz, Bg)
        for b in range(Bg):
            staged = [(t, e) for t in nz[lo:hi] for e in tiles[t][b]]
            assert [e for _, e in staged] == seq[b]


def test_bag_regime_by_entries_a_tile():
    """Sparse tiles take the gather regime: phase 3's random reads at
    k = 16 (853,022 entries in 7,906 tiles) and phase 4's real reads at
    k = 16 (225 entries a tile); denser ones keep the staged ring: random
    reads at k = 10 (424 a tile) and real reads at k = 10 (632)."""
    assert tp.bag_regime(853_022, 7_906) == "gather"
    assert tp.bag_regime(1_775_441, 7_906) == "gather"
    assert tp.bag_regime(1_218_884, 2_875) == "staged"
    assert tp.bag_regime(1_815_859, 2_873) == "staged"
    T = 1000
    assert tp.bag_regime(tp.BAG_GATHER_TILE_ENTRIES * T, T) == "gather"
    assert tp.bag_regime(tp.BAG_GATHER_TILE_ENTRIES * T + 1, T) == "staged"
    assert tp.bag_regime(0, 0) == "gather"


def random_params(seed, V, d, canonical=True):
    """Torch and JAX parameters of a random k=5 vocabulary of V k-mers
    that holds the all-A k-mer."""
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    n = 4**K
    perm = rng.permutation(n)
    perm[[0, int(np.nonzero(perm == 0)[0][0])]] = perm[[int(np.nonzero(perm == 0)[0][0]), 0]]
    lut = np.full(n + 1, V, dtype=np.int32)
    lut[perm[:V]] = np.arange(V, dtype=np.int32)
    tw = rng.standard_normal((V, d)).astype(np.float32)
    metric = np.full(d, 1.0 / d, dtype=np.float32)
    coords = rng.standard_normal((3, d)).astype(np.float32)
    norms = np.ones(3, dtype=np.float32)
    arrays = dict(vocab_lut=lut, twister=tw, metric=metric, class_coords=coords, class_norms=norms)
    tparams = tp.ClassifierParams(*(torch.from_numpy(a) for a in arrays.values()), k=K, canonical=canonical)
    jparams = jp.ClassifierParams(**{k: jnp.asarray(a) for k, a in arrays.items()}, k=K, canonical=canonical)
    return tparams, jparams


def read_like_codes(seed, B, L):
    """[B, L] int8 bases shaped like joined 150 bp reads (chip_smoke.py's
    phase 3 inputs at a small size): -1 breaks every 151 bases, ragged -1
    tails, a row repeating one 10-mer pattern and a row of one k-mer."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=(B, L), dtype=np.int8)
    codes[:, 150::151] = -1
    for i in range(B):
        codes[i, L - int(rng.integers(0, L // 3)) :] = -1
    codes[0] = np.tile(rng.integers(0, 4, size=10, dtype=np.int8), L // 10 + 1)[:L]
    codes[1] = 0
    return codes


def check(tparams, jparams, codes, normalize, n_sm):
    import jax.numpy as jnp

    tc = torch.from_numpy(codes)
    got, counts = emulate_bag(tparams, tc, normalize, n_sm)
    np.testing.assert_array_equal(counts, tp.count_spectra_ref(tparams, tc).numpy())
    want = tp.project_reads_ref(tparams, tc, normalize).numpy()
    jax_bag = np.asarray(jp.project_reads(jparams, jnp.asarray(codes), normalize=normalize, chunk=64))
    # an unnormalized sum of n terms carries n times the rounding of their
    # mean: it is held to the bound after the division by n
    scale = 1.0 if normalize else np.maximum(counts.sum(axis=1), 1)[:, None]
    for ref in (want, jax_bag):
        np.testing.assert_allclose(got / scale, ref / scale, rtol=BAG_RTOL, atol=BAG_ATOL)
    return got


@pytest.mark.parametrize("n_sm", [1, 16, H100_SMS])
@pytest.mark.parametrize("normalize", [True, False])
def test_emulated_bag_on_the_trained_fixture(trained, normalize, n_sm):  # noqa: F811
    jparams, tparams = both_params(trained)
    check(tparams, jparams, codes_of(trained), normalize, n_sm)


@pytest.mark.parametrize("n_sm", [1, 16, H100_SMS])
@pytest.mark.parametrize("normalize", [True, False])
def test_emulated_bag_on_read_like_codes(normalize, n_sm):
    """Two groups of read sets (130 > BAG_GROUP), breaks, ragged tails and
    a row of one k-mer repeated about L times."""
    tparams, jparams = random_params(7, V=600, d=37)
    codes = read_like_codes(8, B=130, L=460)
    got = check(tparams, jparams, codes, normalize, n_sm)
    if normalize:  # one k-mer: count x row / count is the row itself
        np.testing.assert_allclose(got[1], tparams.twister[tparams.vocab_lut[0]].numpy(), rtol=1e-6)


@pytest.mark.parametrize("n_sm", [16, H100_SMS])
def test_emulated_bag_on_bf16_rows(n_sm):
    """A bf16 twister: each row widened to f32 before the same products
    and sums, against the plain version and JAX project_reads on the same
    bf16 twister."""
    import jax.numpy as jnp

    tparams, jparams = random_params(7, V=600, d=37)
    tw = tparams.twister.to(torch.bfloat16)
    tparams = tp.ClassifierParams(tparams.vocab_lut, tw, tparams.metric, tparams.class_coords,
                                  tparams.class_norms, K, True)
    jparams = dataclasses.replace(jparams, twister=jnp.asarray(tw.float().numpy(), dtype=jnp.bfloat16))
    assert np.array_equal(np.asarray(jparams.twister).view(np.int16), tw.view(torch.int16).numpy())
    check(tparams, jparams, read_like_codes(8, B=130, L=460), True, n_sm)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ring_windows_hold_each_row_slice(dtype):
    """The staged ring's copies of a hit row at d = 511, in the rows the
    kernel takes (check_ring_windows: f32 rows of 511, odd, so they start
    at every offset within a chunk; bf16 rows of 512): from the 16-byte
    aligned window at or just before twister[v, col0] (8 elements for
    bf16, 4 for f32), the kernel's chunks of each column block,
    zero-filled past the twister's end; the lane reads column col0 + c at
    the row's shift + c.  Every copy starts on 16 bytes, and an entry's
    staged offset (slot x stride + shift) fits in its 16 bits."""
    check_ring_windows(dtype, 511)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ring_windows_hold_each_row_slice_at_an_even_d(dtype):
    """The same at d = 510, where f32 rows start at the even offsets."""
    check_ring_windows(dtype, 510)


@pytest.mark.parametrize("d", [37, 129])
def test_ring_windows_of_aligned_bf16_rows(d):
    """bf16 rows laid out as the port lays them (pipeline.bf16_rows: a row
    stride of d rounded up to 8 elements) at a narrow d and at one column
    past a block: every window starts at its row, shift 0, and each lane
    reads its 4 consecutive columns as one 8-byte word (word_read)."""
    check_ring_windows(torch.bfloat16, d)


def padded(tw: torch.Tensor, ld: int) -> torch.Tensor:
    """The flat elements of ``tw [V, d]`` in rows of ``ld`` (0 in the
    padding), up to its last element: what the kernel reads."""
    V, d = tw.shape
    out = torch.zeros((V, ld), dtype=tw.dtype)
    out[:, :d] = tw
    return out.reshape(-1)[: (V - 1) * ld + d]


def check_ring_windows(dtype, d):
    """The ring's windows of every row and column block of a random [300,
    d] twister in the rows the kernel takes (f32 contiguous, bf16 as
    pipeline.bf16_rows lays it out, in rows of a multiple of 8), and, for
    bf16 rows, the lanes' reads of 4 consecutive columns each as one 8-byte
    word (word_read)."""
    V = 300
    tw = torch.from_numpy(np.random.default_rng(5).standard_normal((V, d)).astype(np.float32))
    tw = tp.bf16_rows(tw) if dtype == torch.bfloat16 else tw
    ld = tw.stride(0)
    flat = padded(tw, ld)
    size = len(flat)
    # Row<Tw>: elements a 16-byte chunk, chunks a staged row, its elements
    per = 16 // tw.element_size()
    chunks = tp.BAG_COLS // per + 1
    stride = per * chunks
    assert (per, chunks) == ((8, 17) if dtype == torch.bfloat16 else (4, 33))
    assert chunks * 16 >= tp.BAG_COLS * tw.element_size() + 16 - tw.element_size()
    assert (tp.BAG_TILE_ROWS - 1) * stride + per - 1 < 1 << 16
    cols_of = lane_cols(True)
    shifts = set()
    for col0 in range(0, d, tp.BAG_COLS):
        cols = min(tp.BAG_COLS, d - col0)
        inside = col0 + cols_of < d
        for v in range(V):
            start = (v * ld + col0) & ~(per - 1)
            shift = v * ld + col0 - start
            assert start * tw.element_size() % 16 == 0
            staged = torch.zeros(stride, dtype=dtype)
            for q in range(chunks):
                src = start + per * q
                n = max(0, min(per, size - src))  # the bytes the copy reads
                staged[per * q : per * q + n] = flat[src : src + n]
            assert torch.equal(staged[shift : shift + cols], tw[v, col0 : col0 + cols])
            if dtype == torch.bfloat16:
                assert shift == 0
                got = word_read(staged.view(torch.int16).numpy().view(np.uint16), shift)
                want = tw[v].float().numpy()[(col0 + cols_of)[inside]]
                np.testing.assert_array_equal(got[inside], want)
            shifts.add(shift)
    assert shifts == set(range(0, per, math.gcd(ld, per)))


def lane_cols(words: bool) -> np.ndarray:
    """The kernel's lane_col: ``[32, 4]`` columns of each lane within a
    BAG_COLS-column block, interleaved (l + 32 k, f32 rows) or 4
    consecutive a lane (4 l + k, bf16 rows)."""
    lane, k = np.arange(32)[:, None], np.arange(4)[None, :]
    return 4 * lane + k if words else lane + 32 * k


@pytest.mark.parametrize("words", [False, True])
def test_each_column_has_one_owner_lane(words):
    """Both lane maps give each column of a block one (lane, k) owner, so
    each (read set, column) has one owner, which adds its entries in
    order: the lane map does not change a bit of the result."""
    assert sorted(lane_cols(words).ravel().tolist()) == list(range(tp.BAG_COLS))


def word_read(bits: np.ndarray, at: int) -> np.ndarray:
    """A warp's read of the bf16 row slice that starts at element ``at`` (a
    multiple of 4) of ``bits`` (uint16: the twister, as bag_gather's
    read_rows reads it, or a staged window, as the staged ring's add_entry
    does, in the kernel's ALIGNED instantiation): lane l's 8-byte word at
    at + 4 l, zero past the end, widened as widen4.  Returns ``[32, 4]``
    f32, lane by column."""
    assert at % 4 == 0
    size = len(bits)
    e = np.array([[int(bits[w]) if w < size else 0 for w in range(at + 4 * lane, at + 4 * lane + 4)]
                  for lane in range(32)], dtype=np.uint32)
    lo, hi = e[:, 0] | e[:, 1] << 16, e[:, 2] | e[:, 3] << 16
    out = np.stack([lo << 16, lo & 0xFFFF0000, hi << 16, hi & 0xFFFF0000], axis=1)
    return out.astype(np.uint32).view(np.float32)


@pytest.mark.parametrize("d,ld", [(511, 512), (512, 512), (37, 40)])
def test_gather_words_hold_each_row_slice(d, ld):
    """The gather's bf16 rows read by 8-byte words in rows of ``ld`` (a
    multiple of 8, as pipeline.bf16_rows lays them out; at d = 512 a
    contiguous twister is so): each lane's 4 consecutive columns, one
    word, are the row's elements widened to f32, up to the twister's last
    element."""
    V = 40
    tw = torch.from_numpy(np.random.default_rng(5).standard_normal((V, d)).astype(np.float32))
    bits = padded(tw.to(torch.bfloat16), ld).view(torch.int16).numpy().view(np.uint16)
    want = tw.to(torch.bfloat16).float().numpy()
    cols = lane_cols(True)
    shifts = set()
    for col0 in range(0, d, tp.BAG_COLS):
        inside = col0 + cols < d
        for v in range(V):
            got = word_read(bits, v * ld + col0)
            np.testing.assert_array_equal(got[inside], want[v, (col0 + cols)[inside]])
            shifts.add((v * ld + col0) & 3)
    assert shifts == {0}


@pytest.mark.parametrize("d", [511, 37, 512])
def test_bf16_rows_start_on_16_bytes(d):
    """pipeline.bf16_rows: the twister cast to bf16 in rows of d rounded up
    to BF16_ROW_ALIGN elements, each row on 16 bytes, 0 in the padding,
    its values those of the plain cast."""
    tw = torch.from_numpy(np.random.default_rng(6).standard_normal((50, d)).astype(np.float32))
    got = tp.bf16_rows(tw)
    ld = -(-d // tp.BF16_ROW_ALIGN) * tp.BF16_ROW_ALIGN
    assert got.dtype == torch.bfloat16 and got.shape == (50, d) and got.stride() == (ld, 1)
    assert got.data_ptr() % 16 == 0 and ld * 2 % 16 == 0
    assert torch.equal(got, tw.to(torch.bfloat16))
    assert not torch.as_strided(got, (50, ld), (ld, 1))[:, d:].any()
    assert tp.bf16_aligned(got)


@pytest.mark.parametrize("d", [511, 37, 512])
def test_classifier_params_hold_bf16_rows_on_16_bytes(d):
    """ClassifierParams lays a bf16 twister given in other rows (a
    contiguous one at d = 511 or 37) out as pipeline.bf16_rows does, its
    values unchanged, and keeps one already so laid out (d = 512) as it is:
    the bag kernel reads bf16 rows only by aligned words.  f32 twisters
    stay as given."""
    tw = torch.from_numpy(np.random.default_rng(6).standard_normal((50, d)).astype(np.float32))
    flat = tw.to(torch.bfloat16)
    lut = torch.full((4**2 + 1,), 50, dtype=torch.int32)
    rest = (torch.ones(d), torch.zeros((3, d)), torch.ones(3), 2, True)
    held = tp.ClassifierParams(lut, flat, *rest).twister
    ld = -(-d // tp.BF16_ROW_ALIGN) * tp.BF16_ROW_ALIGN
    assert tp.bf16_aligned(held) and held.stride() == (ld, 1) and torch.equal(held, flat)
    assert (held.data_ptr() == flat.data_ptr()) == (d % tp.BF16_ROW_ALIGN == 0)
    assert not tp.bf16_aligned(flat) or d % tp.BF16_ROW_ALIGN == 0
    assert tp.ClassifierParams(lut, tw, *rest).twister is tw


def test_emulated_bag_does_not_depend_on_the_key_order():
    """Integer counts do not see the order in which the scatter wrote the
    keys: two orders give the same bits."""
    tparams, _ = random_params(9, V=300, d=20)
    codes = torch.from_numpy(read_like_codes(10, B=12, L=300))
    a, _ = emulate_bag(tparams, codes, n_sm=16, seed=1)
    b, _ = emulate_bag(tparams, codes, n_sm=16, seed=2)
    assert np.array_equal(a, b)


def test_slices_spread_a_stretch_of_sparse_tiles():
    """Dense tiles first, then a long stretch of tiles of one key each (a
    vocabulary's rarely hit k-mers, as phase 4's real reads hit them): a
    split by keys alone puts the whole stretch in one slice; the kernel's
    split by keys plus tiles keeps every slice within twice its share."""
    keys = np.array([5000] * 60 + [1] * 2000)
    kbase = np.concatenate([[0], np.cumsum(keys)])
    S = 33
    starts = slice_starts(kbase, S)
    tiles = np.diff(starts)
    cost = np.diff(kbase[starts]) + keys.sum() // len(keys) * tiles
    assert cost.max() <= 2 * cost.sum() / S
    by_keys = np.searchsorted(kbase * S, np.arange(S + 1) * kbase[-1], side="left")
    assert np.diff(by_keys).max() >= 2000 > 2 * tiles.max()


def test_bag_plan_at_the_headline_batch():
    """368k rows x 511 columns: tiles of 128 rows (a hit mask of 4 words),
    and slices x 4 column blocks fill the card's SMs once, an accumulate
    block an SM."""
    assert tp.BAG_TILE_ROWS == 128
    assert tp.bag_plan(367_987, 511) * 4 == H100_SMS


@pytest.mark.parametrize("V,d,n_sm", [
    (10, 511, 132),         # fewer tiles than the card's blocks
    (367_987, 70_000, 132),  # more column blocks than blocks
    (16_777_216, 1, 100_000),  # within grid.y
    (1000, 200, 1),
])
def test_bag_plan_limits(V, d, n_sm):
    S = tp.bag_plan(V, d, n_sm)
    assert 1 <= S <= min(-(-V // tp.BAG_TILE_ROWS), 65535)


def test_bag_workspace_holds_each_pass():
    """The int32 workspace grows with the windows of one pass, not with
    the batch: 3 ints a window of up to BAG_GROUP read sets."""
    one = tp.bag_workspace_ints(tp.BAG_GROUP, 1000, 10, 5000)
    assert tp.bag_workspace_ints(3 * tp.BAG_GROUP, 1000, 10, 5000) == one
    assert one - tp.bag_workspace_ints(tp.BAG_GROUP - 1, 1000, 10, 5000) == 3 * 991
