import numpy as np
import pytest

from hairsplitter_jax.core.mapping import map_reads
from hairsplitter_jax.ops.cluster import chinese_whispers_matmul, cw_numpy, sims_diffs
from hairsplitter_jax.pipeline.call_variants import call_variants_for_contig
from hairsplitter_jax.pipeline.separate_reads import (
    SeparateConfig,
    create_read_graph,
    separate_reads_for_contig,
)
from hairsplitter_jax.utils.sim import make_haplotypes, mutate, simulate_reads


def test_sims_diffs_matmul():
    # 4 reads, 2 snps: reads 0,1 alt at both; reads 2,3 ref at both
    A = np.array([[1, 1], [1, 1], [0, 0], [0, 0]], np.float32)
    R = np.array([[0, 0], [0, 0], [1, 1], [1, 1]], np.float32)
    sim, diff = map(np.asarray, sims_diffs(A, R))
    assert sim[0, 1] == 6  # 3 * 2 shared alt
    assert sim[2, 3] == 2  # 2 shared ref
    assert sim[0, 2] == 0
    assert diff[0, 2] == 2
    assert diff[0, 1] == 0
    assert sim[0, 0] == 0 and diff[2, 2] == 0


def _two_cluster_adj(n1=8, n2=8):
    n = n1 + n2
    adj = np.zeros((n, n), np.int8)
    adj[:n1, :n1] = 1
    adj[n1:, n1:] = 1
    np.fill_diagonal(adj, 0)
    # one weak cross edge
    adj[0, n1] = adj[n1, 0] = 1
    return adj


def test_cw_numpy_two_clusters():
    adj = _two_cluster_adj()
    n = adj.shape[0]
    init = np.arange(n)
    mask = np.ones(n, bool)
    labels = cw_numpy(adj, init, mask)
    assert len(set(labels[:8].tolist())) == 1
    assert len(set(labels[8:].tolist())) == 1
    assert labels[0] != labels[8]


def test_cw_matmul_matches_numpy():
    adj = _two_cluster_adj(10, 6)
    n = adj.shape[0]
    init = np.arange(n)
    mask = np.ones(n, bool)
    ref = cw_numpy(adj, init, mask)
    dev = np.asarray(
        chinese_whispers_matmul(adj.astype(np.float32), init.astype(np.int32), mask)
    )
    # same partition structure (labels may differ)
    def canon(lab):
        seen = {}
        return [seen.setdefault(l, len(seen)) for l in lab]

    assert canon(ref) == canon(dev)


def test_cw_masked_nodes():
    adj = _two_cluster_adj()
    n = adj.shape[0]
    mask = np.ones(n, bool)
    mask[3] = False
    labels = cw_numpy(adj, np.arange(n), mask)
    assert labels[3] == -2


def test_create_read_graph_links_same_hap():
    # 6 reads: 0-2 alt at 5 snps, 3-5 ref (5 snps so ref-ref pairs clear the
    # sim+diff >= 5 compatibility floor, `src/separate_reads.cpp:462`)
    A = np.zeros((6, 5), np.float32)
    R = np.zeros((6, 5), np.float32)
    A[:3] = 1
    R[3:] = 1
    sim = 3 * A @ A.T + R @ R.T
    diff = A @ R.T + R @ A.T
    np.fill_diagonal(sim, 0)
    np.fill_diagonal(diff, 0)
    mask = np.ones(6, bool)
    adj = create_read_graph(mask, sim.astype(np.int32), diff.astype(np.int32), 0.05)
    assert adj[0, 1] and adj[1, 2] and adj[3, 4]
    assert not adj[0, 3] and not adj[2, 5]


def _phased_contig(rng, length=6000, cov=20, err=0.0):
    consensus = make_haplotypes(length, 1, 0.001, rng)[0]
    hap2, snp_pos = mutate(consensus, 0.01, rng)
    sim = simulate_reads(
        [consensus, hap2], coverage=cov, read_len=1500, rng=rng,
        sub_rate=err, ins_rate=err / 2, del_rate=err / 2,
    )
    alns = map_reads({"ctg": consensus}, sim.seqs)
    read_seqs = {i: s for i, s in enumerate(sim.seqs)}
    cv = call_variants_for_contig("ctg", consensus, alns, read_seqs)
    return consensus, sim, alns, cv


def _check_separation(sim, alns, groups, min_accuracy=0.9):
    """Within each window, clusters should be haplotype-pure and both
    haplotypes present in separated windows."""
    truth = np.array([sim.hap_of_read[a.read_idx] for a in alns])
    n_separated = 0
    for w in groups.windows:
        labs = w.labels
        present = labs >= 0
        if present.sum() < 10:
            continue
        uniq = set(labs[present].tolist())
        if len(uniq) < 2:
            continue
        n_separated += 1
        # purity: each cluster should be dominated by one haplotype
        impure = 0
        total = 0
        for g in uniq:
            in_g = labs == g
            h = truth[in_g]
            if in_g.sum() == 0:
                continue
            maj = np.bincount(h).max()
            impure += in_g.sum() - maj
            total += in_g.sum()
        assert impure <= (1 - min_accuracy) * total, (w.start, impure, total)
    return n_separated


def test_separate_reads_clean(rng):
    consensus, sim, alns, cv = _phased_contig(rng)
    spans = [(a.t_start, a.t_end) for a in alns]
    groups = separate_reads_for_contig(cv, spans)
    # windows tile the contig
    assert groups.windows[0].start == 0
    assert groups.windows[-1].end == len(consensus)
    for w1, w2 in zip(groups.windows[:-1], groups.windows[1:]):
        assert w2.start == w1.end + 1
    n_sep = _check_separation(sim, alns, groups, min_accuracy=0.95)
    assert n_sep >= len(groups.windows) - 2, f"only {n_sep} separated windows"


def test_separate_reads_noisy(rng):
    consensus, sim, alns, cv = _phased_contig(rng, err=0.06)
    spans = [(a.t_start, a.t_end) for a in alns]
    groups = separate_reads_for_contig(cv, spans)
    n_sep = _check_separation(sim, alns, groups, min_accuracy=0.85)
    assert n_sep >= 1


def test_ploidy_cap(rng):
    consensus, sim, alns, cv = _phased_contig(rng)
    spans = [(a.t_start, a.t_end) for a in alns]
    groups = separate_reads_for_contig(cv, spans, max_haplotypes=1)
    for w in groups.windows:
        labs = w.labels
        assert len(set(labs[labs >= 0].tolist())) <= 1


def test_sims_diffs_packed_matches():
    """Bit-packed indicator transfer gives identical sim/diff matrices."""
    from hairsplitter_jax.ops.cluster import sims_diffs_packed

    rng = np.random.default_rng(4)
    n, S = 64, 96
    A = (rng.random((n, S)) < 0.3).astype(np.float32)
    R = ((rng.random((n, S)) < 0.6) * (A == 0)).astype(np.float32)
    sim0, diff0 = map(np.asarray, sims_diffs(A, R))
    Ap = np.packbits(A.astype(np.uint8), axis=1, bitorder="little")
    Rp = np.packbits(R.astype(np.uint8), axis=1, bitorder="little")
    sim1, diff1 = map(np.asarray, sims_diffs_packed(Ap, Rp))
    assert np.array_equal(sim0, sim1)
    assert np.array_equal(diff0, diff1)
