"""Hand-computed cases for stage 5's trickiest logic: stitch_groups +
merge_intervals (reference create_new_contigs.cpp:833-903, 1427-1533)."""

import numpy as np

from hairsplitter_jax.pipeline.new_contigs import Interval, merge_intervals, stitch_groups


def _iv(start, end, labels):
    return Interval(start, end, np.asarray(labels, dtype=np.int64))


def test_stitch_groups_basic_bijection():
    # 10 reads; groups 0/1 on the left continue into 1/0 on the right
    left = np.array([0] * 5 + [1] * 5)
    right = np.array([1] * 5 + [0] * 5)
    st = stitch_groups(left, right)
    assert st == {0: {1}, 1: {0}}


def test_stitch_groups_threshold():
    # a shared-read count below min(5, 0.7*size) is not a stitch:
    # group 0 has 10 reads, 3 of which continue into right group 1 (3 < 5
    # and 3 < 7) while 7 continue into right group 0
    left = np.zeros(10, dtype=np.int64)
    right = np.array([1, 1, 1] + [0] * 7)
    st = stitch_groups(left, right)
    assert st[0] == {0}


def test_stitch_groups_absent_reads_ignored():
    # -1/-2 rows (unclustered / absent) never count toward stitches
    left = np.array([0, 0, 0, 0, 0, -1, -2])
    right = np.array([1, 1, 1, 1, 1, 1, 1])
    st = stitch_groups(left, right)
    assert st[0] == {1}


def test_merge_intervals_trivial_bijection_fuses():
    # two windows, the same 2-way split with renamed groups -> one interval
    labels1 = np.array([0] * 6 + [1] * 6)
    labels2 = np.array([1] * 6 + [0] * 6)
    out = merge_intervals([_iv(0, 999, labels1), _iv(1000, 1999, labels2)])
    assert len(out) == 1
    assert out[0].start == 0 and out[0].end == 1999
    # left labels win
    assert out[0].labels.tolist() == labels1.tolist()


def test_merge_intervals_fill_unassigned_from_right():
    # reads absent on the left inherit the converted right label
    labels1 = np.array([0, 0, 0, 0, 0, 1, 1, 1, 1, 1, -1])
    labels2 = np.array([1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0])
    out = merge_intervals([_iv(0, 999, labels1), _iv(1000, 1999, labels2)])
    assert len(out) == 1
    # right group 0 converts to left group 1, so the last read becomes 1
    assert out[0].labels[-1] == 1


def test_merge_intervals_split_count_change_keeps_boundary():
    # 2 groups -> 3 groups is not a bijection: intervals stay separate
    labels1 = np.array([0] * 6 + [1] * 6 + [1] * 6)
    labels2 = np.array([0] * 6 + [1] * 6 + [2] * 6)
    out = merge_intervals([_iv(0, 999, labels1), _iv(1000, 1999, labels2)])
    assert len(out) == 2


def test_merge_intervals_crossing_stitch_keeps_boundary():
    # both left groups continue into BOTH right groups (a real recombination
    # signal): not trivial, keep the boundary
    labels1 = np.array([0] * 10 + [1] * 10)
    labels2 = np.array([0] * 5 + [1] * 5 + [0] * 5 + [1] * 5)
    out = merge_intervals([_iv(0, 999, labels1), _iv(1000, 1999, labels2)])
    assert len(out) == 2


def test_merge_intervals_chain_of_three():
    # three windows with consistent bijections collapse into one interval
    a = np.array([0] * 6 + [1] * 6)
    out = merge_intervals([_iv(0, 99, a), _iv(100, 199, a.copy()), _iv(200, 299, a.copy())])
    assert len(out) == 1
    assert (out[0].start, out[0].end) == (0, 299)


def test_merge_intervals_unclaimed_right_group():
    # a right group claimed by nobody is claimed by every left group
    # (reference fallback): with one left group and two right groups where
    # only one is stitched, the unclaimed one folds in -> NOT a bijection
    # (one left -> two rights), so the boundary stays
    labels1 = np.array([0] * 10 + [-2] * 4)
    labels2 = np.array([0] * 10 + [1] * 4)
    out = merge_intervals([_iv(0, 999, labels1), _iv(1000, 1999, labels2)])
    assert len(out) == 2
