"""Base-level fidelity of the in-process consensus (the racon replacement)."""

import numpy as np

from hairsplitter_jax.constants import encode_seq
from hairsplitter_jax.core.mapping import map_reads
from hairsplitter_jax.ops.consensus import consensus_from_cells, majority_counts
from hairsplitter_jax.pipeline.pileup import alignment_cells_full, orient_read
from hairsplitter_jax.utils.sim import make_haplotypes, mutate, simulate_reads


def _edit_distance(a, b):
    import numpy as np

    m = np.zeros((len(a) + 1, len(b) + 1), dtype=int)
    m[:, 0] = np.arange(len(a) + 1)
    m[0, :] = np.arange(len(b) + 1)
    for i in range(1, len(a) + 1):
        row = m[i]
        prev = m[i - 1]
        ai = a[i - 1]
        for j in range(1, len(b) + 1):
            row[j] = min(prev[j - 1] + (ai != b[j - 1]), prev[j] + 1, row[j - 1] + 1)
    return int(m[len(a), len(b)])


def _consensus_of(backbone, truth, rng, cov=30, err=0.05):
    """Simulate reads from `truth`, align to `backbone`, build consensus."""
    sim = simulate_reads(
        [truth], coverage=cov, read_len=len(truth), rng=rng,
        sub_rate=err, ins_rate=err / 2, del_rate=err / 2,
    )
    alns = map_reads({"b": backbone}, sim.seqs)
    cells, inss = [], []
    for a in alns:
        oriented = orient_read(encode_seq(sim.seqs[a.read_idx]), a.strand)
        tpos, tri, it, ic = alignment_cells_full(a, oriented)
        cells.append((tpos, (np.asarray(tri, np.int16) // 25).astype(np.int8)))
        inss.append((it, ic))
    return consensus_from_cells(encode_seq(backbone), 0, cells, inss)


def test_majority_counts_op():
    codes = np.array([[0, 1, 4], [0, 2, 4], [0, 1, 1]], dtype=np.int8)
    counts = np.asarray(majority_counts(codes))
    assert counts.shape == (3, 5)
    assert counts[0, 0] == 3  # all A in col 0
    assert counts[2, 4] == 2  # two deletions in col 2


def test_consensus_recovers_truth_from_noisy_reads(rng):
    truth = make_haplotypes(2000, 1, 0.001, rng)[0]
    cons = _consensus_of(truth, truth, rng, cov=30, err=0.06)
    d = _edit_distance(cons, truth)
    # < 1 error per kb from 6%-error reads at 30x
    assert d <= 2, d


def test_consensus_recovers_divergent_haplotype(rng):
    # backbone differs from the true haplotype (subs + indels); the consensus
    # of the reads must converge to the TRUE haplotype, not the backbone
    backbone = make_haplotypes(2000, 1, 0.001, rng)[0]
    truth_sub, _ = mutate(backbone, 0.01, rng)
    # add a small insertion and deletion
    truth = truth_sub[:500] + "ACGTT" + truth_sub[500:1200] + truth_sub[1208:]
    cons = _consensus_of(backbone, truth, rng, cov=30, err=0.03)
    d_truth = _edit_distance(cons, truth)
    d_backbone = _edit_distance(cons, backbone)
    assert d_truth <= 4, d_truth
    assert d_backbone > 15  # clearly moved away from the backbone


def test_consensus_exact_at_ultra_noise(rng):
    """28% total read error (old-ONT worst case): the rescue mapping pass
    (core/mapping.py MapConfig.rescue) keeps coverage full, so the pileup
    vote stays exact; iterative polish must not degrade it."""
    from hairsplitter_jax.ops.consensus import polish_iterative
    from hairsplitter_jax.utils.sim import simulate_reads as _sr

    truth = make_haplotypes(2000, 1, 0.001, rng)[0]
    cons = _consensus_of(truth, truth, rng, cov=30, err=0.14)
    assert _edit_distance(cons, truth) <= 2
    sim = _sr([truth], coverage=30, read_len=2000, rng=rng,
              sub_rate=0.14, ins_rate=0.07, del_rate=0.07)
    cons2 = polish_iterative(cons, sim.seqs, rounds=2)
    assert _edit_distance(cons2, truth) <= 2
