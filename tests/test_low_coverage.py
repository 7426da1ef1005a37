"""Low-coverage / skewed-abundance recovery (round-5 frontier).

A ~5x-absolute rare strain must survive phasing: fractional window
membership (separate_reads.py:span_mode), low-support variant admission +
CW partition clustering (call_variants.py), weak-cut community splitting
and chain-friendly continuity rescue (separate_reads.py). The reference's
strict spanning + flat floors lose such strains
(`separate_reads.cpp:936,1590-1621`, `call_variants.cpp:526`).
"""

import numpy as np
import pytest

from hairsplitter_jax.io.fasta import write_fasta
from hairsplitter_jax.io.gfa import parse_gfa
from hairsplitter_jax.pipeline.orchestrate import PipelineConfig, run_pipeline
from hairsplitter_jax.utils import sim as S
from hairsplitter_jax.utils.evaluate import evaluate_phasing


@pytest.mark.slow
def test_rare_strain_5x_recovered(tmp_path):
    rng = np.random.default_rng(11)
    haps = S.make_haplotypes(60_000, 3, 0.01, rng)
    reads = S.simulate_reads(
        haps, coverage=30.0, read_len=8000, rng=rng,
        sub_rate=0.06, ins_rate=0.02, del_rate=0.02,
        abundances=[1.0, 0.5, 5.0 / 30.0], uniform_edges=True,
    )
    asm = str(tmp_path / "asm.fasta")
    rd = str(tmp_path / "reads.fasta")
    write_fasta(asm, {"collapsed": haps[0]})
    S.write_sim_fasta(rd, reads)
    final = run_pipeline(asm, rd, str(tmp_path / "out"), PipelineConfig())
    g = parse_gfa(final)
    ev = evaluate_phasing(g.segments, haps)
    assert ev.haplotype_recovery[0] >= 0.99
    assert ev.haplotype_recovery[1] >= 0.99
    assert ev.haplotype_recovery[2] >= 0.85, (
        f"rare (~5x) strain recovery {ev.haplotype_recovery[2]:.3f}"
    )
    assert ev.total_switch_errors == 0


def test_split_communities_weak_cut():
    """A tight triangle welded to a dense cluster by one edge splits off;
    a well-connected cluster does not."""
    from hairsplitter_jax.pipeline.separate_reads import split_communities

    n = 19
    adj = np.zeros((n, n), dtype=np.int8)
    # dense cluster: nodes 0..15 (ring + chords)
    for i in range(16):
        for j in (1, 2, 3):
            adj[i, (i + j) % 16] = adj[(i + j) % 16, i] = 1
    # triangle 16,17,18
    for a, b in [(16, 17), (17, 18), (16, 18)]:
        adj[a, b] = adj[b, a] = 1
    adj[0, 16] = adj[16, 0] = 1  # single weak bridge
    labels = np.zeros(n, dtype=np.int64)  # all one label (absorbed)
    mask = np.ones(n, dtype=bool)
    out = split_communities(labels, adj, mask)
    tri = set(out[[16, 17, 18]].tolist())
    big = set(out[:16].tolist())
    assert len(tri) == 1 and tri.isdisjoint(big), "triangle must split off"
    assert len(big) == 1, "dense cluster must stay whole"
