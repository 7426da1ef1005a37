"""Hi-C untangling and the spectral (BiHap-equivalent) phaser."""

import numpy as np

from hairsplitter_jax.core.mapping import map_reads
from hairsplitter_jax.io.gfa import AssemblyGraph, Link
from hairsplitter_jax.models.bihap import spectral_phase, write_bihap_solution
from hairsplitter_jax.pipeline.call_variants import call_variants_for_contig
from hairsplitter_jax.pipeline.hic import (
    interaction_matrix_from_pairs,
    untangle_with_interactions,
)
from hairsplitter_jax.utils.sim import make_haplotypes, mutate, simulate_reads


def test_hic_untangle_diamond():
    # A and C both feed into shared S which exits to B and D: long reads are
    # too short to resolve it, but Hi-C interactions pair A<->B and C<->D
    g = AssemblyGraph()
    for n in "ABCD":
        g.add_segment(n, "ACGT" * 500, depth=10)
    g.add_segment("S", "TTTT" * 500, depth=20)
    for a, b in (("A", "S"), ("C", "S"), ("S", "B"), ("S", "D")):
        g.add_link(Link(a, "+", b, "+"))
    pairs = [("A", "B")] * 30 + [("C", "D")] * 30 + [("A", "D")] * 2
    im = interaction_matrix_from_pairs(list(g.segments), pairs)
    resolved = untangle_with_interactions(g, im)
    assert resolved == 1
    # S duplicated per matched pair (the original is deleted, like the
    # reference's simple_unzip duplication)
    assert "S" not in g.segments
    assert {"S-copy1", "S-copy2"} <= set(g.segments)
    keys = {(l.name1, l.name2) for l in g.links}
    # each copy carries one (left, right) pairing consistent with Hi-C
    paths = set()
    for s_name in ("S-copy1", "S-copy2"):
        lefts = [a for a, b in keys if b == s_name]
        rights = [b for a, b in keys if a == s_name]
        assert len(lefts) == 1 and len(rights) == 1
        paths.add((lefts[0], rights[0]))
    assert paths == {("A", "B"), ("C", "D")}


def test_spectral_phase_two_haplotypes(rng):
    # BiHap's setting: amplicon-like full-length reads -> a dense read x SNP
    # matrix whose leading singular vector splits the haplotypes
    consensus = make_haplotypes(3000, 1, 0.001, rng)[0]
    hap2, _ = mutate(consensus, 0.01, rng)
    sim = simulate_reads([consensus, hap2], coverage=20, read_len=3000, rng=rng, sub_rate=0.01)
    alns = map_reads({"ctg": consensus}, sim.seqs)
    read_seqs = {i: s for i, s in enumerate(sim.seqs)}
    cv = call_variants_for_contig("ctg", consensus, alns, read_seqs)
    labels = spectral_phase(cv.columns, len(alns), n_haplotypes=2)
    truth = np.array([sim.hap_of_read[a.read_idx] for a in alns])
    present = labels >= 0
    assert present.sum() > 0.8 * len(alns)
    impure = 0
    tot = 0
    for g_ in set(labels[present].tolist()):
        h = truth[labels == g_]
        impure += h.size - np.bincount(h).max()
        tot += h.size
    assert impure <= 0.1 * tot, (impure, tot)


def test_bihap_solution_file(tmp_path):
    p = str(tmp_path / "sol.txt")
    write_bihap_solution(p, "ctg", ["r1", "r2"], np.array([0, 1]))
    txt = open(p).read()
    assert "CONTIG\tctg" in txt and "LABELS\t0,1" in txt


def test_sinkhorn_normalize_rows():
    from hairsplitter_jax.pipeline.hic_solve import sinkhorn_normalize

    m = np.array([[0, 8, 1], [8, 0, 3], [1, 3, 0]], dtype=float)
    w = sinkhorn_normalize(m)
    assert np.all(np.diag(w) == 0)
    sums = w.sum(axis=1)
    assert np.allclose(sums[sums > 0], 1.0)


def _diamond(depth_mid=20, mid_names=("S",)):
    g = AssemblyGraph()
    for n in "ABCD":
        g.add_segment(n, "ACGT" * 500, depth=10)
    prev = None
    for m in mid_names:
        g.add_segment(m, "TTTT" * 500, depth=depth_mid)
        if prev:
            g.add_link(Link(prev, "+", m, "+"))
        prev = m
    g.add_link(Link("A", "+", mid_names[0], "+"))
    g.add_link(Link("C", "+", mid_names[0], "+"))
    g.add_link(Link(mid_names[-1], "+", "B", "+"))
    g.add_link(Link(mid_names[-1], "+", "D", "+"))
    return g


def test_solve_with_interactions_knot():
    # the full iterative solver (reference solve_with_HiC.py:37-180): a
    # collapsed knot of TWO chained repeat contigs between 4 anchors
    from hairsplitter_jax.pipeline.hic_solve import solve_with_interactions

    g = _diamond(depth_mid=20, mid_names=("S", "T"))
    names = list(g.segments)
    pairs = [("A", "B")] * 30 + [("C", "D")] * 30 + [("A", "D")] * 2
    from hairsplitter_jax.pipeline.hic import interaction_matrix_from_pairs

    im = interaction_matrix_from_pairs(names, pairs)
    rep = solve_with_interactions(g, names, im.m)
    assert rep.knots_solved >= 1
    assert rep.contigs_duplicated == 4  # S and T duplicated once per path
    assert "S" not in g.segments and "T" not in g.segments
    # each anchor pair is now chained through its own copies
    keys = {(l.name1, l.name2) for l in g.links}

    def chain_from(a):
        cur, seen = a, []
        while True:
            nxts = [b for x, b in keys if x == cur]
            if not nxts:
                return seen
            cur = nxts[0]
            seen.append(cur)

    assert chain_from("A")[-1] == "B"
    assert chain_from("C")[-1] == "D"


def test_solve_with_interactions_no_signal_leaves_graph_alone():
    from hairsplitter_jax.pipeline.hic_solve import solve_with_interactions

    g = _diamond()
    names = list(g.segments)
    rep = solve_with_interactions(g, names, np.zeros((len(names), len(names))))
    assert rep.contigs_duplicated == 0
    assert "S" in g.segments


def test_find_anchor_contigs_modes():
    from hairsplitter_jax.pipeline.hic_solve import find_anchor_contigs

    g = _diamond(depth_mid=20)
    # confident coverage: the 2x-depth middle contig is not an anchor
    anchors = find_anchor_contigs(g, confident_coverage=True)
    assert set("ABCD") <= set(anchors)
    assert "S" not in anchors
    # without coverage confidence: topology only (<=1 link per side) — the
    # middle contig has 2 links per side and is excluded either way
    anchors2 = find_anchor_contigs(g, confident_coverage=False)
    assert set("ABCD") <= set(anchors2)
    assert "S" not in anchors2
