"""Amplicon mode: whole-contig windowing (reference -x amplicon,
`separate_reads.cpp:1494-1498` — the window covers the longest contig)."""

import numpy as np

from hairsplitter_jax.core.mapping import map_reads
from hairsplitter_jax.pipeline.call_variants import call_variants_for_contig
from hairsplitter_jax.pipeline.separate_reads import SeparateConfig, separate_reads_for_contig
from hairsplitter_jax.utils.sim import make_haplotypes, mutate, simulate_reads


def test_amplicon_single_window(rng):
    consensus = make_haplotypes(3000, 1, 0.001, rng)[0]
    hap2, _ = mutate(consensus, 0.01, rng)
    # amplicon reads: full-length, both strands
    sim = simulate_reads([consensus, hap2], coverage=25, read_len=3000, rng=rng, sub_rate=0.01)
    alns = map_reads({"amp": consensus}, sim.seqs)
    read_seqs = {i: s for i, s in enumerate(sim.seqs)}
    cv = call_variants_for_contig("amp", consensus, alns, read_seqs)
    spans = [(a.t_start, a.t_end) for a in alns]
    groups = separate_reads_for_contig(cv, spans, SeparateConfig(amplicon=True))
    assert len(groups.windows) == 1
    w = groups.windows[0]
    assert (w.start, w.end) == (0, 3000)
    labs = w.labels
    present = labs >= 0
    assert len(set(labs[present].tolist())) == 2
    truth = np.array([sim.hap_of_read[a.read_idx] for a in alns])
    impure = 0
    for g in set(labs[present].tolist()):
        h = truth[labs == g]
        impure += h.size - np.bincount(h).max()
    assert impure <= 0.05 * int(present.sum())
