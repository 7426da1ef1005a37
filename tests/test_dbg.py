"""Contig-space DBG untangling (reference `contig_DBG.py:373` capability).

The headline case: a 3-contig collapsed repeat with 2 flanks per side and
reads spanning at most 3 contigs. The path-support untangler cannot touch
it (`duplicate_contigs` needs single reads reaching beyond BOTH dilemma
ends — a 5-contig span no read has), while the DBG chains overlapping
reads into unitigs that extend the flanks through the repeat.
"""

import numpy as np

from hairsplitter_jax.io.gfa import AssemblyGraph, Link
from hairsplitter_jax.pipeline.dbg import build_dbg, dbg_unzip, paths_to_chunk_paths, unitigs
from hairsplitter_jax.pipeline.unzip import duplicate_contigs
from hairsplitter_jax.utils.sim import random_genome


def _knot():
    """A(2k) B(2k) -> R1 R2 R3 (2k each) -> C(2k) D(2k), collapsed."""
    rng = np.random.default_rng(0)
    g = AssemblyGraph()
    seqs = {n: random_genome(2000, rng) for n in ["A", "B", "R1", "R2", "R3", "C", "D"]}
    for n, s in seqs.items():
        g.add_segment(n, s, depth=20.0 if n.startswith("R") else 10.0)
    for n in ("A", "B"):
        g.add_link(Link(n, "+", "R1", "+"))
    g.add_link(Link("R1", "+", "R2", "+"))
    g.add_link(Link("R2", "+", "R3", "+"))
    for n in ("C", "D"):
        g.add_link(Link("R3", "+", n, "+"))
    # reads span <= 3 contigs; several per adjacency
    paths = {}
    rid = 0
    for _ in range(3):
        for p in (
            [("A", 1), ("R1", 1), ("R2", 1)],
            [("B", 1), ("R1", 1), ("R2", 1)],
            [("R1", 1), ("R2", 1), ("R3", 1)],
            [("R2", 1), ("R3", 1), ("C", 1)],
            [("R2", 1), ("R3", 1), ("D", 1)],
        ):
            paths[rid] = list(p)
            rid += 1
    return g, seqs, paths


def test_path_support_cannot_resolve_the_knot():
    g, _seqs, paths = _knot()
    copy_of = duplicate_contigs(g, {k: list(v) for k, v in paths.items()})
    # no single read reaches beyond both dilemmas -> nothing duplicated
    assert copy_of == {}
    assert set(g.segments) == {"A", "B", "R1", "R2", "R3", "C", "D"}


def test_dbg_resolves_the_knot():
    g, seqs, paths = _knot()
    out = dbg_unzip(g, paths, k_max=9, chunk=1000)
    # flanks must be EXTENDED through the repeat: some output contig contains
    # A's full sequence followed by R1's start (and likewise for B) — on
    # either strand (canonical kmers may store the RC)
    joined = list(out.segments.values()) + [_rc(s) for s in out.segments.values()]
    for flank in ("A", "B"):
        probe = seqs[flank] + seqs["R1"][:500]
        assert any(probe in s for s in joined), f"{flank} not extended into the repeat"
    for flank in ("C", "D"):
        probe = seqs["R3"][-500:] + seqs[flank]
        assert any(probe in s for s in joined), f"{flank} not extended into the repeat"
    # total k-mer content preserved (nothing lost)
    k = 31
    def kmers(s):
        return {s[i : i + k] for i in range(len(s) - k + 1)}
    truth = set()
    for hap in (
        seqs["A"] + seqs["R1"] + seqs["R2"] + seqs["R3"] + seqs["C"],
        seqs["B"] + seqs["R1"] + seqs["R2"] + seqs["R3"] + seqs["D"],
    ):
        truth |= kmers(hap)
    have = set()
    for s in joined:
        have |= kmers(s)
    # interior junction kmers (A|R1 etc.) must exist in the output
    missing = sum(1 for x in truth if x not in have)
    assert missing == 0, f"{missing} truth k-mers missing from DBG output"


def test_dbg_unitigs_linear_chain():
    """A clean linear path assembles into ONE unitig chain (no read spans
    the whole thing; evidence chains across reads)."""
    g = AssemblyGraph()
    rng = np.random.default_rng(1)
    names = ["u1", "u2", "u3", "u4"]
    for n in names:
        g.add_segment(n, random_genome(1500, rng), depth=10.0)
    for a, b in zip(names[:-1], names[1:]):
        g.add_link(Link(a, "+", b, "+"))
    paths = {0: [("u1", 1), ("u2", 1)], 1: [("u2", 1), ("u3", 1)], 2: [("u3", 1), ("u4", 1)],
             3: [("u1", 1), ("u2", 1)], 4: [("u2", 1), ("u3", 1)], 5: [("u3", 1), ("u4", 1)]}
    out = dbg_unzip(g, paths, k_max=9, chunk=1000)
    full = g.segments["u1"] + g.segments["u2"] + g.segments["u3"] + g.segments["u4"]
    assert any(full in s or full in _rc(s) for s in out.segments.values())


def _rc(s):
    from hairsplitter_jax.constants import revcomp

    return revcomp(s)


def test_dbg_build_canonicalization_deterministic():
    sym_path = [("x", 0, 1), ("y", 0, 1), ("z", 0, 0)]
    d1 = build_dbg(2, [sym_path])
    d2 = build_dbg(2, [list(sym_path)])
    assert d1.abundance == d2.abundance
    assert set(d1.succ) == set(d2.succ)
    u1 = unitigs(d1, 2)
    u2 = unitigs(d2, 2)
    assert u1 == u2
