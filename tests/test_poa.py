"""POA consensus (racon parity, round 3).

The reference polishes read groups with racon (windowed SPOA,
`src/tools.cpp:317-557`); `native/hs_native.cpp:hs_poa_consensus` +
`ops/poa.py:polish_poa` are the in-process equivalent. These tests pin the
claimed quality: exact recovery at 10% layer error, and a clear win over the
pileup vote on very noisy reads.
"""

import numpy as np
import pytest

from hairsplitter_jax import native
from hairsplitter_jax.core.mapping import MapConfig, map_reads
from hairsplitter_jax.ops.poa import poa_available, polish_poa
from hairsplitter_jax.utils.sim import random_genome, simulate_reads

pytestmark = pytest.mark.skipif(not poa_available(), reason="native library unavailable")


def _mutate(x, rate, rng):
    out = []
    for c in x:
        r = rng.random()
        if r < rate / 3:
            continue
        elif r < 2 * rate / 3:
            out.append(rng.integers(0, 4))
        else:
            out.append(c)
        if rng.random() < rate / 3:
            out.append(rng.integers(0, 4))
    return np.array(out, np.int8)


def _identity(truth: str, query: str) -> float:
    alns = map_reads({"t": truth}, [query], MapConfig())
    if not alns:
        return 0.0
    a = max(alns, key=lambda x: x.q_end - x.q_start)
    return 1.0 - a.nm / max(1, a.q_end - a.q_start)


def test_poa_identical_layers_roundtrip():
    rng = np.random.default_rng(0)
    s = rng.integers(0, 4, 80).astype(np.int8)
    out = native.poa_consensus([s, s, s], min_cov=1)
    np.testing.assert_array_equal(out, s)


def test_poa_recovers_truth_at_10pct():
    rng = np.random.default_rng(0)
    truth = rng.integers(0, 4, 500).astype(np.int8)
    layers = [_mutate(truth, 0.10, rng) for _ in range(20)]
    out = native.poa_consensus([_mutate(truth, 0.10, rng)] + layers, min_cov=10)
    np.testing.assert_array_equal(out, truth)


def test_poa_near_exact_at_20pct():
    rng = np.random.default_rng(1)
    truth = rng.integers(0, 4, 500).astype(np.int8)
    layers = [_mutate(truth, 0.20, rng) for _ in range(25)]
    out = native.poa_consensus([_mutate(truth, 0.20, rng)] + layers, min_cov=12)
    assert out is not None
    # alignment-free bound: length within 1% and >= 98% positional agreement
    assert abs(out.size - truth.size) <= 5
    m = min(out.size, truth.size)
    assert np.mean(out[:m] == truth[:m]) > 0.9 or _identity(
        "".join("ACGT"[c] for c in truth), "".join("ACGT"[c] for c in out)
    ) > 0.99


def test_polish_poa_beats_vote_on_noisy_reads():
    """The reference's own ladder is consensus-vote then racon; at 18% read
    error the vote plateaus while vote+POA pushes past 99.5% identity."""
    from hairsplitter_jax.ops.consensus import polish_iterative

    rng = np.random.default_rng(5)
    truth = random_genome(1500, rng)
    err = 0.18
    sim = simulate_reads(
        [truth], coverage=30, read_len=1500, rng=rng,
        sub_rate=err / 2, ins_rate=err / 4, del_rate=err / 4,
    )
    draft = sim.seqs[0]
    vote = polish_iterative(draft, list(sim.seqs), rounds=2)
    hybrid = polish_poa(vote, list(sim.seqs), rounds=2)
    id_vote = _identity(truth, vote)
    id_hybrid = _identity(truth, hybrid)
    assert id_hybrid > id_vote
    assert id_hybrid >= 0.995


def test_polish_poa_noop_on_clean_reads():
    rng = np.random.default_rng(9)
    truth = random_genome(1200, rng)
    sim = simulate_reads([truth], coverage=20, read_len=1200, rng=rng,
                         sub_rate=0.01, ins_rate=0.005, del_rate=0.005)
    out = polish_poa(truth, list(sim.seqs), rounds=1)
    assert _identity(truth, out) >= 0.999


def test_poa_batch_matches_per_window():
    """hs_poa_consensus_batch (threaded) is bit-identical to per-window
    hs_poa_consensus calls on the same layers."""
    from hairsplitter_jax import native

    if native.get_lib() is None:
        import pytest

        pytest.skip("native library unavailable")
    rng = np.random.default_rng(11)
    windows, covs = [], []
    for _ in range(7):
        backbone = rng.integers(0, 4, int(rng.integers(80, 400))).astype(np.int8)
        layers = [backbone]
        for _ in range(int(rng.integers(2, 12))):
            keep = rng.random(backbone.size) > 0.1
            mut = np.where(
                rng.random(backbone.size) < 0.08,
                rng.integers(0, 4, backbone.size),
                backbone,
            )
            layers.append(mut[keep].astype(np.int8))
        windows.append(layers)
        covs.append(len(layers) // 2)
    ref = [native.poa_consensus(ls, min_cov=c) for ls, c in zip(windows, covs)]
    got = native.poa_consensus_batch(windows, min_covs=covs)
    assert got is not None
    for a, b in zip(ref, got):
        assert np.array_equal(a, b)


def test_polish_poa_multi_matches_single():
    """Joint multi-group POA polish (one restricted mapping + one POA batch)
    recovers each group's truth like the per-group path."""
    from hairsplitter_jax.ops.poa import polish_poa_multi

    rng = np.random.default_rng(21)
    truths = [random_genome(1200, rng) for _ in range(3)]
    drafts, read_lists = [], []
    for t in truths:
        sim = simulate_reads(
            [t], coverage=24, read_len=1200, rng=rng,
            sub_rate=0.06, ins_rate=0.03, del_rate=0.03,
        )
        drafts.append(sim.seqs[0])
        read_lists.append(list(sim.seqs))
    multi = polish_poa_multi(drafts, read_lists, rounds=2)
    singles = [polish_poa(d, rs, rounds=2) for d, rs in zip(drafts, read_lists)]
    for t, m, s in zip(truths, multi, singles):
        assert _identity(t, m) >= 0.99
        assert _identity(t, s) >= 0.99


def test_map_reads_restrict_pins_reads_to_their_draft():
    """With `restrict`, reads never map across homologous drafts."""
    from hairsplitter_jax.core.mapping import map_reads

    rng = np.random.default_rng(33)
    base = random_genome(3000, rng)
    # two near-identical haplotype drafts
    h2 = list(base)
    for p in rng.integers(0, len(h2), 30):
        h2[p] = "ACGT"[rng.integers(0, 4)]
    drafts = {"d0": base, "d1": "".join(h2)}
    sim0 = simulate_reads([base], coverage=4, read_len=1500, rng=rng,
                          sub_rate=0.02, ins_rate=0.01, del_rate=0.01)
    reads = list(sim0.seqs)
    restrict = ["d1"] * len(reads)  # force everything onto d1
    alns = map_reads(drafts, reads, restrict=restrict)
    assert alns, "restricted mapping found no alignments"
    assert all(a.contig == "d1" for a in alns)
