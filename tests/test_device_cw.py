"""Device-batched CW path: same separation quality as the host path."""

import numpy as np

from hairsplitter_jax.core.mapping import map_reads
from hairsplitter_jax.ops.cluster import chinese_whispers_multi
from hairsplitter_jax.pipeline.call_variants import call_variants_for_contig
from hairsplitter_jax.pipeline.separate_reads import SeparateConfig, separate_reads_for_contig
from hairsplitter_jax.utils.sim import make_haplotypes, mutate, simulate_reads


def test_cw_multi_shapes():
    n = 16
    adj = np.zeros((n, n), np.float32)
    adj[:8, :8] = 1
    adj[8:, 8:] = 1
    np.fill_diagonal(adj, 0)
    inits = np.stack([np.arange(n), np.arange(n)[::-1]]).astype(np.int32)
    labs = np.asarray(chinese_whispers_multi(adj, inits, np.ones(n, bool)))
    assert labs.shape == (2, n)
    for k in range(2):
        assert len(set(labs[k, :8].tolist())) == 1
        assert len(set(labs[k, 8:].tolist())) == 1
        assert labs[k, 0] != labs[k, 8]


def test_device_cw_pipeline_separates(rng):
    consensus = make_haplotypes(6000, 1, 0.001, rng)[0]
    hap2, _ = mutate(consensus, 0.01, rng)
    sim = simulate_reads([consensus, hap2], coverage=20, read_len=1500, rng=rng)
    alns = map_reads({"ctg": consensus}, sim.seqs)
    read_seqs = {i: s for i, s in enumerate(sim.seqs)}
    cv = call_variants_for_contig("ctg", consensus, alns, read_seqs)
    spans = [(a.t_start, a.t_end) for a in alns]
    groups = separate_reads_for_contig(cv, spans, SeparateConfig(use_device_cw=True))
    truth = np.array([sim.hap_of_read[a.read_idx] for a in alns])
    n_sep = 0
    for w in groups.windows:
        labs = w.labels
        present = labs >= 0
        uniq = set(labs[present].tolist())
        if len(uniq) < 2:
            continue
        n_sep += 1
        impure = 0
        for g in uniq:
            h = truth[labs == g]
            impure += h.size - np.bincount(h).max()
        assert impure <= 0.1 * int(present.sum())
    assert n_sep >= len(groups.windows) - 3
