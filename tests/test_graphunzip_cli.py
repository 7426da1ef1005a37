"""Standalone GraphUnzip-equivalent CLI (hairsplitter_jax/graphunzip.py)."""

import numpy as np
import pytest

from hairsplitter_jax.graphunzip import main as gz_main
from hairsplitter_jax.io.gfa import parse_gfa
from hairsplitter_jax.utils.sim import random_genome


def _gaf_line(read, path, qlen=1000):
    return f"{read}\t{qlen}\t0\t{qlen}\t+\t{path}\t3000\t0\t3000\t950\t1000\t60\tid:f:0.95\n"


@pytest.fixture
def collapsed_graph(tmp_path, rng):
    """A1/A2 -> X (collapsed) -> C1/C2 with read paths pairing A1-C1, A2-C2."""
    seqs = {n: random_genome(800, rng) for n in ("A1", "A2", "C1", "C2")}
    seqs["X"] = random_genome(1200, rng)
    gfa = tmp_path / "in.gfa"
    with open(gfa, "w") as f:
        for n, s in seqs.items():
            f.write(f"S\t{n}\t{s}\tDP:f:20\n")
        for a in ("A1", "A2"):
            f.write(f"L\t{a}\t+\tX\t+\t0M\n")
        for c in ("C1", "C2"):
            f.write(f"L\tX\t+\t{c}\t+\t0M\n")
    gaf = tmp_path / "aln.gaf"
    with open(gaf, "w") as f:
        for k in range(3):
            f.write(_gaf_line(f"r1_{k}", ">A1>X>C1"))
            f.write(_gaf_line(f"r2_{k}", ">A2>X>C2"))
    return gfa, gaf, seqs


def test_unzip_subcommand_duplicates_collapsed_node(collapsed_graph, tmp_path):
    gfa, gaf, seqs = collapsed_graph
    out = tmp_path / "out.gfa"
    sup = tmp_path / "supercontigs.txt"
    rc = gz_main(
        ["unzip", "-g", str(gfa), "-l", str(gaf), "-o", str(out), "-e",
         "--supercontigs", str(sup)]
    )
    assert rc == 0
    g = parse_gfa(str(out))
    # X was duplicated and each A-X-C chain merged into one supercontig
    assert len(g.segments) == 2
    joined = sorted(g.segments.values())
    expect = sorted([seqs["A1"] + seqs["X"] + seqs["C1"], seqs["A2"] + seqs["X"] + seqs["C2"]])
    assert joined == expect
    assert sup.exists() and len(sup.read_text().splitlines()) == 2


def test_hic_im_and_untangle(tmp_path, rng):
    """Hi-C mates drawn from the true haplotype junctions resolve X."""
    seqs = {n: random_genome(1500, rng) for n in ("A1", "A2", "C1", "C2")}
    seqs["X"] = random_genome(1500, rng)
    gfa = tmp_path / "in.gfa"
    with open(gfa, "w") as f:
        for n, s in seqs.items():
            f.write(f"S\t{n}\t{s}\tDP:f:20\n")
        for a in ("A1", "A2"):
            f.write(f"L\t{a}\t+\tX\t+\t0M\n")
        for c in ("C1", "C2"):
            f.write(f"L\tX\t+\t{c}\t+\t0M\n")
    # mate pairs: one end in A_i, the other in C_i (same haplotype)
    r1, r2 = tmp_path / "r1.fa", tmp_path / "r2.fa"
    with open(r1, "w") as f1, open(r2, "w") as f2:
        k = 0
        for a, c in (("A1", "C1"), ("A2", "C2")):
            for _ in range(8):
                s1 = int(rng.integers(0, 1000))
                s2 = int(rng.integers(0, 1000))
                f1.write(f">p{k}\n{seqs[a][s1:s1+400]}\n")
                f2.write(f">p{k}\n{seqs[c][s2:s2+400]}\n")
                k += 1
    im_path = tmp_path / "im.npz"
    assert gz_main(["hic-im", "-g", str(gfa), "-1", str(r1), "-2", str(r2), "-o", str(im_path)]) == 0
    data = np.load(im_path, allow_pickle=True)
    names = list(data["names"])
    m = data["m"]
    assert m[names.index("A1"), names.index("C1")] >= 6
    assert m[names.index("A1"), names.index("C2")] == 0

    out = tmp_path / "out.gfa"
    assert gz_main(["untangle-im", "-g", str(gfa), "-m", str(im_path), "-o", str(out)]) == 0
    g = parse_gfa(str(out))
    assert len(g.segments) == 2  # two phased supercontigs


def test_repolish_structural_variant_fallback(rng):
    # a duplicated copy diverges structurally from its assigned reads (the
    # reads carry a 250bp block the copy lacks): the reference falls back to
    # cutting reads between flanking anchors and polishing the best-anchored
    # read (repolish.py:295-453); the copy must come out with the block
    from hairsplitter_jax.constants import revcomp
    from hairsplitter_jax.graphunzip import _repolish_copies
    from hairsplitter_jax.io.gfa import AssemblyGraph
    from hairsplitter_jax.utils.sim import simulate_reads

    base = random_genome(2500, rng)
    insert = random_genome(250, rng)
    truth = base[:1200] + insert + base[1200:]
    g = AssemblyGraph()
    g.add_segment("X", base, 10)
    sim = simulate_reads([truth], coverage=12, read_len=1500, rng=rng, sub_rate=0.01)
    by_row = {i: s for i, s in enumerate(sim.seqs)}
    read_paths = {i: [("X", 1)] for i in by_row}
    n = _repolish_copies(g, {"X": "X"}, read_paths, by_row)
    assert n == 1
    out = g.segments["X"]

    def ov(a, b, k=21):
        ka = {a[i : i + k] for i in range(len(a) - k + 1)}
        kb = {b[i : i + k] for i in range(len(b) - k + 1)}
        return len(ka & kb) / max(1, len(ka))

    assert abs(len(out) - len(truth)) < 80, (len(out), len(truth))
    assert max(ov(out, truth), ov(revcomp(out), truth)) > 0.9


def test_duplicate_multiway(rng):
    # reference finish_untangling.py:223-268 (-D): a deep contig whose 2+2
    # neighbors each hang off it by their only link is duplicated per
    # one-side neighbor with proportional depth; a shallow neighbor (<0.2x)
    # blocks duplication
    from hairsplitter_jax.io.gfa import AssemblyGraph, Link
    from hairsplitter_jax.pipeline.unzip import _neighbors, duplicate_multiway

    g = AssemblyGraph()
    for n, d in (("A", 12), ("B", 8), ("C", 12), ("D", 8), ("X", 20)):
        g.add_segment(n, random_genome(1500, rng), depth=d)
    g.add_link(Link("A", "+", "X", "+"))
    g.add_link(Link("B", "+", "X", "+"))
    g.add_link(Link("X", "+", "C", "+"))
    g.add_link(Link("X", "+", "D", "+"))
    made = duplicate_multiway(g)
    assert made == 2
    assert "X" not in g.segments
    dups = sorted(n for n in g.segments if n.startswith("X-dup"))
    assert len(dups) == 2
    # proportional depth split: 20 * 12/20 and 20 * 8/20
    assert sorted(round(g.depths[n], 2) for n in dups) == [8.0, 12.0]
    # each copy has exactly one neighbor on the duplicated side and both on
    # the other (which side is duplicated depends on scan order, like the
    # reference's end loop)
    for n in dups:
        counts = sorted((len(_neighbors(g, n, "-")), len(_neighbors(g, n, "+"))))
        assert counts == [1, 2], counts

    # a long contig much shallower than its neighbors is NOT a collapsed
    # repeat: depth > 0.7 * sum(neighbors) fails on both ends
    g2 = AssemblyGraph()
    for n, d in (("A", 12), ("B", 8), ("C", 12), ("D", 8), ("X", 5)):
        g2.add_segment(n, random_genome(1500, rng), depth=d)
    g2.add_link(Link("A", "+", "X", "+"))
    g2.add_link(Link("B", "+", "X", "+"))
    g2.add_link(Link("X", "+", "C", "+"))
    g2.add_link(Link("X", "+", "D", "+"))
    assert duplicate_multiway(g2) == 0
    assert "X" in g2.segments
