import numpy as np
import pytest

from hairsplitter_jax.constants import decode_seq, encode_seq, revcomp, trimer_central, trimer_pack
from hairsplitter_jax.io import (
    AssemblyGraph,
    Link,
    ReadStore,
    cigar_query_len,
    cigar_target_len,
    cigar_to_string,
    compress_cigar,
    cut_assembly,
    expand_cigar,
    parse_cigar,
    parse_gfa,
    read_fasta,
    write_fasta,
    write_gfa,
)
from hairsplitter_jax.io.cigar import merge_cigars
from hairsplitter_jax.utils.sim import make_haplotypes, simulate_reads, write_sim_fasta


def test_encode_decode_roundtrip():
    s = "ACGTACGT-N"
    codes = encode_seq(s)
    assert decode_seq(codes) == "ACGTACGT-N"
    assert revcomp("ACGT") == "ACGT"
    assert revcomp("AACG") == "CGTT"


def test_trimer_pack_central():
    cur = np.array([0, 3, 4])
    p1 = np.array([1, 2, 0])
    p2 = np.array([2, 1, 0])
    t = trimer_pack(cur, p1, p2)
    assert (trimer_central(t) == cur).all()
    # distinct context -> distinct code even with same central base
    a = trimer_pack(np.array([1]), np.array([0]), np.array([0]))
    b = trimer_pack(np.array([1]), np.array([2]), np.array([0]))
    assert a[0] != b[0]


def test_fasta_roundtrip(tmp_path):
    seqs = {"a": "ACGTACGT", "b": "GGGG"}
    p = str(tmp_path / "x.fasta")
    write_fasta(p, seqs)
    assert read_fasta(p) == seqs
    store = ReadStore(p)
    assert store.names == ["a", "b"]
    assert store.lengths.tolist() == [8, 4]
    assert store.get_seq(1) == "GGGG"
    assert store.get_seq_by_name("a") == "ACGTACGT"
    store.free()
    assert store.get_seq(0) == "ACGTACGT"


def test_fasta_multiline_and_fastq(tmp_path):
    p = str(tmp_path / "m.fa")
    with open(p, "w") as f:
        f.write(">r1 desc\nACGT\nACGT\n>r2\nTTTT\n")
    store = ReadStore(p)
    assert store.get_seq(0) == "ACGTACGT"
    assert store.names == ["r1", "r2"]
    q = str(tmp_path / "m.fq")
    with open(q, "w") as f:
        f.write("@r1\nACGTA\n+\nIIIII\n@r2\nGG\n+\nII\n")
    sq = ReadStore(q)
    assert sq.get_seq(0) == "ACGTA"
    assert sq.get_seq(1) == "GG"


def test_gfa_roundtrip(tmp_path):
    g = AssemblyGraph()
    g.add_segment("c1", "ACGT", depth=2.5)
    g.add_segment("c2", "TTTT")
    g.add_link(Link("c1", "+", "c2", "+", "0M"))
    p = str(tmp_path / "g.gfa")
    write_gfa(g, p)
    g2 = parse_gfa(p)
    assert g2.segments == {"c1": "ACGT", "c2": "TTTT"}
    assert abs(g2.depths["c1"] - 2.5) < 1e-6
    assert g2.links[0] == Link("c1", "+", "c2", "+", "0M")
    assert g.normalized() == g2.normalized()


def test_cut_assembly():
    g = AssemblyGraph()
    g.add_segment("long", "A" * 250)
    g.add_segment("short", "C" * 50)
    g.add_link(Link("long", "+", "short", "+"))
    g.add_link(Link("short", "+", "long", "+"))
    cut = cut_assembly(g, max_len=100)
    assert set(cut.segments) == {"long@0", "long@1", "long@2", "short@0"}
    assert len(cut.segments["long@2"]) == 50
    chain = [(l.name1, l.name2) for l in cut.links]
    assert ("long@0", "long@1") in chain and ("long@1", "long@2") in chain
    # '+' from 'long' leaves its end -> last chunk; '+' into 'long' enters first chunk
    assert ("long@2", "short@0") in chain
    assert ("short@0", "long@0") in chain


def test_cigar_utils():
    ops, lens = parse_cigar("3=1X2I2D4=")
    assert cigar_to_string(ops, lens) == "3=1X2I2D4="
    assert cigar_query_len(ops, lens) == 10
    assert cigar_target_len(ops, lens) == 10
    exp = expand_cigar(ops, lens)
    o2, l2 = compress_cigar(exp)
    assert cigar_to_string(o2, l2) == "3=1X2I2D4="
    mo, ml = merge_cigars([(ops[:2], lens[:2]), (ops[2:], lens[2:])])
    assert cigar_to_string(mo, ml) == "3=1X2I2D4="
    # seam fusion
    a = parse_cigar("5=")
    b = parse_cigar("3=")
    mo, ml = merge_cigars([a, b])
    assert cigar_to_string(mo, ml) == "8="


def test_simulator(tmp_path, rng):
    haps = make_haplotypes(2000, 2, 0.02, rng)
    assert len(haps) == 2 and len(haps[0]) == 2000
    diff = sum(a != b for a, b in zip(*haps))
    assert 20 <= diff <= 160
    sim = simulate_reads(haps, coverage=5, read_len=500, rng=rng, sub_rate=0.01)
    assert len(sim.seqs) >= 2 * 5 * 2000 // 500
    p = str(tmp_path / "reads.fa")
    write_sim_fasta(p, sim)
    store = ReadStore(p)
    assert len(store) == len(sim.seqs)
