"""Host graph stages at metagenome scale (round-5 #4).

5 Mbp / 5,000 contigs / 6,000 read paths must untangle in seconds, not
minutes: adjacency-indexed AssemblyGraph (O(degree) neighbor queries and
segment removal), a once-built occurrence index in duplicate_contigs, a
worklist merge_linear_chains, and a vectorized merge_to_ploidy.
"""

import time

import numpy as np

from hairsplitter_jax.io.gfa import AssemblyGraph, Link
from hairsplitter_jax.pipeline.unzip import unzip
from hairsplitter_jax.utils.sim import random_genome


def test_5mbp_5000_contig_untangle_under_10s(rng):
    g = AssemblyGraph()
    read_paths = {}
    rid = 0
    for u in range(500):
        names = [f"u{u}_s{i}" for i in range(10)]
        for i, n in enumerate(names):
            g.add_segment(n, random_genome(1000, rng), depth=20.0 if i in (0, 9) else 10.0)
        # chain with a bubble: s0 -> (s1..s4 | s5..s8) -> s9
        for a, b in [(0, 1), (1, 2), (2, 3), (3, 4), (4, 9), (0, 5), (5, 6), (6, 7), (7, 8), (8, 9)]:
            g.add_link(Link(names[a], "+", names[b], "+"))
        for _ in range(6):
            read_paths[rid] = [(names[0], 1), (names[1], 1), (names[2], 1),
                               (names[3], 1), (names[4], 1), (names[9], 1)]
            rid += 1
            read_paths[rid] = [(names[0], 1), (names[5], 1), (names[6], 1),
                               (names[7], 1), (names[8], 1), (names[9], 1)]
            rid += 1
    assert len(g.segments) == 5000
    t0 = time.time()
    ur = unzip(g, read_paths, merge=True)
    dt = time.time() - t0
    # every bubble resolves into 2 chains sharing duplicated flanks: 4/unit
    assert len(ur.graph.segments) == 2000
    assert dt < 10, f"untangle took {dt:.1f}s on 5 Mbp / 5000 contigs"


def test_adjacency_index_consistency():
    """links_of / remove_segment keep the index in sync with the list API."""
    g = AssemblyGraph()
    for n in "abcd":
        g.add_segment(n, "ACGT" * 10)
    g.add_link(Link("a", "+", "b", "+"))
    g.add_link(Link("b", "+", "c", "+"))
    g.add_link(Link("c", "+", "d", "+"))
    g.add_link(Link("a", "-", "c", "-"))
    assert len(g.links_of("b")) == 2
    assert len(g.links_of("a")) == 2
    g.remove_segment("b")
    assert len(g.links) == 2
    assert g.links_of("b") == []
    assert len(g.links_of("a")) == 1 and len(g.links_of("c")) == 2
    # list assignment rebuilds the index
    g.links = [Link("c", "+", "d", "+")]
    assert g.links_of("a") == [] and len(g.links_of("c")) == 1
    # add after assignment
    g.add_link(Link("d", "+", "c", "+"))
    assert len(g.links_of("c")) == 2
    np_links = g.links
    assert len(np_links) == 2
