"""Native C++ host-runtime library vs the Python reference implementations."""

import numpy as np
import pytest

from hairsplitter_jax import native
from hairsplitter_jax.core.seeding import _lis_monotonic
from hairsplitter_jax.ops.cluster import cw_numpy
from hairsplitter_jax.pipeline.separate_reads import create_read_graph


needs_native = pytest.mark.skipif(native.get_lib() is None, reason="native lib unavailable")


@needs_native
def test_native_lis(rng):
    for _ in range(20):
        n = int(rng.integers(1, 60))
        t = np.sort(rng.integers(0, 1000, n)).astype(np.int64)
        q = rng.integers(0, 1000, n).astype(np.int64)
        ref = _lis_monotonic(q, t)
        nat = native.lis_monotonic(q)
        # same length is the LIS invariant; indices may differ on ties
        assert nat.size == ref.size
        assert (np.diff(q[nat]) > 0).all() or nat.size <= 1


@needs_native
def test_native_read_graph_matches_python(rng):
    n = 40
    A = (rng.random((n, 12)) < 0.3).astype(np.float32)
    R = ((rng.random((n, 12)) < 0.6) & (A == 0)).astype(np.float32)
    sim = (3 * A @ A.T + R @ R.T).astype(np.int32)
    diff = (A @ R.T + R @ A.T).astype(np.int32)
    np.fill_diagonal(sim, 0)
    np.fill_diagonal(diff, 0)
    mask = rng.random(n) < 0.9
    ref = create_read_graph(mask, sim, diff, 0.05)
    nat = native.create_read_graph(sim, diff, mask, 0.05)
    np.testing.assert_array_equal(ref, nat)


@needs_native
def test_native_cw_two_clusters():
    n1 = n2 = 8
    n = n1 + n2
    adj = np.zeros((n, n), np.int8)
    adj[:n1, :n1] = 1
    adj[n1:, n1:] = 1
    np.fill_diagonal(adj, 0)
    adj[0, n1] = adj[n1, 0] = 1
    labels = native.chinese_whispers(adj, np.arange(n), np.ones(n, bool))
    assert len(set(labels[:n1].tolist())) == 1
    assert len(set(labels[n1:].tolist())) == 1
    assert labels[0] != labels[n1]
    # masked nodes stay -2
    mask = np.ones(n, bool)
    mask[3] = False
    labels = native.chinese_whispers(adj, np.arange(n), mask)
    assert labels[3] == -2


def test_native_minimizers_bit_identical(rng):
    from hairsplitter_jax import native
    from hairsplitter_jax.constants import encode_seq
    from hairsplitter_jax.core.seeding import _minimizers_numpy

    if native.get_lib() is None:
        import pytest

        pytest.skip("native lib unavailable")
    for n, k, w in ((5000, 15, 10), (200, 11, 6), (16, 15, 10), (10, 15, 10), (0, 15, 10)):
        seq = "".join(rng.choice(list("ACGTN"), p=[0.24, 0.24, 0.24, 0.24, 0.04], size=n))
        codes = encode_seq(seq)
        ref = _minimizers_numpy(codes, k, w)
        got = native.minimizers(codes, k, w)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)


def test_native_chain_sweep_bit_identical(rng):
    from hairsplitter_jax import native
    from hairsplitter_jax.core.seeding import chain_anchors

    if native.get_lib() is None:
        import pytest

        pytest.skip("native lib unavailable")
    # compare the full chain_anchors output against the pure-python sweep by
    # monkeypatching the native hook off
    for trial in range(5):
        n = int(rng.integers(2, 400))
        t = np.sort(rng.integers(0, 20000, n)).astype(np.int64)
        q = (t - 1000 + rng.integers(-600, 600, n)).astype(np.int64)
        ref_breaks = []
        # python reference sweep
        diag = t - q
        start, ref_diag = 0, int(diag[0])
        ref_breaks.append(0)
        for i in range(1, n + 1):
            if i == n or t[i] - t[i - 1] > 5000 or abs(int(diag[i]) - ref_diag) > 500:
                if i < n:
                    ref_breaks.append(i)
                    ref_diag = int(diag[i])
            else:
                ref_diag = (ref_diag * 3 + int(diag[i])) // 4
        ref_breaks.append(n)
        got = native.chain_sweep(q, t, 5000, 500)
        np.testing.assert_array_equal(got, np.asarray(ref_breaks, np.int64))


def test_native_select_pins_bit_identical(rng):
    from hairsplitter_jax import native
    from hairsplitter_jax.core.mapping import MapConfig, select_pins

    if native.get_lib() is None:
        import pytest

        pytest.skip("native lib unavailable")
    cfg = MapConfig()
    B, T, md = cfg.spec.chunk, cfg.spec.t_width, cfg.maxdrift
    import hairsplitter_jax.native as nat

    for trial in range(10):
        n = int(rng.integers(2, 120))
        qa = np.cumsum(rng.integers(1, 700, n)).astype(np.int64)
        ta = (qa + rng.integers(-40, 40, n)).astype(np.int64)
        ta = np.maximum.accumulate(ta + np.arange(n))  # strictly increasing-ish
        keep = np.ones(n, bool)
        keep[1:] = (np.diff(qa) > 0) & (np.diff(ta) > 0)
        qa, ta = qa[keep], ta[keep]
        got = select_pins(qa, ta, cfg)
        # force the python path
        orig = nat.select_pins
        nat.select_pins = lambda *a, **k: None
        try:
            ref = select_pins(qa, ta, cfg)
        finally:
            nat.select_pins = orig
        assert got == ref


def test_native_merge_close_clusters_bit_identical(rng):
    """50-cluster window microbenchmark correctness: the C++ twin must
    reproduce the numpy merge_close_clusters label for label (VERDICT r3
    next-round #9; reference cluster_graph.cpp:402-501)."""
    from hairsplitter_jax import native as N
    from hairsplitter_jax.pipeline import separate_reads as SR

    if N.get_lib() is None:
        import pytest

        pytest.skip("native library unavailable")
    n = 600
    G = 50
    labels = rng.integers(0, G, n).astype(np.int64)
    # a handful of weak clusters with few members
    for g in range(40, 50):
        labels[labels == g] = rng.integers(0, 5)
    labels[rng.random(n) < 0.05] = -1
    mask = rng.random(n) < 0.95
    labels[~mask] = -2
    adj = np.zeros((n, n), np.int8)
    # intra-cluster edges dense, inter sparse
    for i in range(n):
        same = np.nonzero((labels == labels[i]) & (np.arange(n) != i))[0]
        if same.size:
            pick = rng.choice(same, size=min(6, same.size), replace=False)
            adj[i, pick] = 1
            adj[pick, i] = 1
        other = rng.integers(0, n, 3)
        adj[i, other] = 1
        adj[other, i] = 1
    np.fill_diagonal(adj, 0)

    nat = N.merge_close_clusters(adj, labels, mask.astype(np.uint8))
    assert nat is not None
    real = N.merge_close_clusters
    N.merge_close_clusters = lambda *a: None  # force the numpy path
    try:
        ref = SR.merge_close_clusters(adj, labels, mask)
    finally:
        N.merge_close_clusters = real
    np.testing.assert_array_equal(nat, ref)
