"""The row groups in which kpop_tpu_torch's count and bag wrappers launch
their kernels (ops/pipeline.py: count_row_groups, bag_row_groups), and the
plain versions taken in such groups.

The count kernel's lookup takes at most COUNT_MAX_ROWS = 65,535 read sets
a launch (its grid.y); the bag kernel indexes a pass's keys and entries in
int32, so 2 Bg W must stay within 2^31 - 1 for Bg read sets of W windows.
A larger batch is counted, or bagged, group by group into its rows of the
output; a read set of more windows than one group can hold raises.  On the CPU the wrappers run their plain versions, whose output
rows each depend only on their own read set: taken in groups, the count
gives the same bits and the bag the same values within its tolerance."""

import numpy as np
import pytest
import torch

from kpop_tpu_torch.ops import pipeline as tp

from test_torch_bag import BAG_ATOL, BAG_RTOL, random_params, read_like_codes

INT_MAX = 2**31 - 1


def covers(groups, B):
    """Consecutive groups that cover [0, B) once."""
    assert groups[0][0] == 0 and groups[-1][1] == B
    assert all(b1 == a0 for (_, b1), (a0, _) in zip(groups, groups[1:]))
    assert all(b1 > b0 for b0, b1 in groups) or B == 0


def test_count_groups_at_70000_read_sets():
    groups = tp.count_row_groups(70_000)
    assert groups == [(0, 65_535), (65_535, 70_000)]
    covers(groups, 70_000)


@pytest.mark.parametrize("B", [1, 128, 65_535])
def test_count_takes_a_batch_within_its_grid_in_one_launch(B):
    assert tp.count_row_groups(B) == [(0, B)]


@pytest.mark.parametrize("B", [128, 300, 1])
def test_bag_below_the_key_limit_takes_one_launch(B):
    """W = 8,388,607 windows: 2 x 128 x W = 2^31 - 256 fits, so the kernel
    takes the batch in one launch and walks it in passes of BAG_GROUP."""
    W = 8_388_607
    assert 2 * tp.BAG_GROUP * W <= INT_MAX
    assert tp.bag_row_groups(B, W) == [(0, B)]


@pytest.mark.parametrize("B", [128, 300, 1])
def test_bag_above_the_key_limit_takes_groups(B):
    """W = 8,388,608 windows: 2 x 128 x W = 2^31 does not fit; groups of
    the largest Bg with 2 Bg W <= 2^31 - 1 (127)."""
    W = 8_388_608
    groups = tp.bag_row_groups(B, W)
    covers(groups, B)
    rows = max(b1 - b0 for b0, b1 in groups)
    assert rows == min(B, 127)
    assert 2 * 127 * W <= INT_MAX < 2 * 128 * W
    assert all(b1 - b0 == 127 for b0, b1 in groups[:-1])


def test_bag_groups_at_the_windows_guard():
    """Around 2^24 windows, where the wrappers stopped until they took each
    read set's integer count of known windows as its normaliser, and past
    it: just below 2^24 groups of 64 read sets, at 2^24 of 63, and at
    upstream's M. tuberculosis read sets (88,818,792 windows: 294,102
    pairs of 150 bp reads joined by N, k = 12) groups of 12."""
    for W, rows in (((1 << 24) - 1, 64), (1 << 24, 63), (88_818_792, 12)):
        groups = tp.bag_row_groups(200, W)
        covers(groups, 200)
        assert max(b1 - b0 for b0, b1 in groups) == rows
        assert 2 * rows * W <= INT_MAX < 2 * (rows + 1) * W


@pytest.mark.parametrize("rows", [1, 7, 64])
def test_grouped_plain_versions_equal_ungrouped(rows):
    """The count and the bag, plain, on 130 read sets taken in groups of
    ``rows`` (tp.row_groups) into their rows of the output, against the
    whole batch at once: the count the same bits; the bag the same bits in
    groups of one read set, and within the bag's tolerance
    (tests/test_torch_bag.py) in larger groups, since the order of torch's
    f32 sum over the windows on the CPU depends on the batch."""
    tparams, _ = random_params(7, V=600, d=37)
    codes = torch.from_numpy(read_like_codes(8, B=130, L=460))
    groups = tp.row_groups(130, rows)
    covers(groups, 130)
    for fn, width in ((tp.count_spectra_ref, 600), (tp.project_reads_ref, 37)):
        whole = fn(tparams, codes)
        out = torch.empty((130, width), dtype=torch.float32)
        for b0, b1 in groups:
            out[b0:b1] = fn(tparams, codes[b0:b1])
        if fn is tp.count_spectra_ref or rows == 1:
            assert torch.equal(out, whole)
        else:
            torch.testing.assert_close(out, whole, rtol=BAG_RTOL, atol=BAG_ATOL)


def test_wrappers_on_the_cpu_take_the_plain_versions():
    """On CPU tensors the wrappers are their plain versions, whatever the
    batch."""
    tparams, _ = random_params(9, V=300, d=20)
    codes = torch.from_numpy(read_like_codes(10, B=12, L=300))
    assert torch.equal(tp.count_spectra(tparams, codes), tp.count_spectra_ref(tparams, codes))
    assert torch.equal(tp.project_reads(tparams, codes), tp.project_reads_ref(tparams, codes))
    assert np.array_equal(tp.row_groups(0, 5), [(0, 0)])
