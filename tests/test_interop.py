import numpy as np

from hairsplitter_jax.core.mapping import map_reads
from hairsplitter_jax.io.col_gro import read_col, read_gro, write_col, write_gro
from hairsplitter_jax.io.sam import parse_sam, write_sam
from hairsplitter_jax.pipeline.call_variants import call_variants_for_contig
from hairsplitter_jax.pipeline.separate_reads import separate_reads_for_contig
from hairsplitter_jax.utils.sim import make_haplotypes, mutate, simulate_reads


def _dataset(rng):
    consensus = make_haplotypes(4000, 1, 0.001, rng)[0]
    hap2, _ = mutate(consensus, 0.01, rng)
    sim = simulate_reads([consensus, hap2], coverage=12, read_len=1500, rng=rng)
    alns = map_reads({"ctg": consensus}, sim.seqs)
    read_seqs = {i: s for i, s in enumerate(sim.seqs)}
    return consensus, sim, alns, read_seqs


def test_col_gro_roundtrip(tmp_path, rng):
    consensus, sim, alns, read_seqs = _dataset(rng)
    cv = call_variants_for_contig("ctg", consensus, alns, read_seqs)
    assert cv.columns
    names = {i: n for i, n in enumerate(sim.names)}
    col_path = str(tmp_path / "variants.col")
    write_col(col_path, {"ctg": cv}, {"ctg": alns}, names)
    back = read_col(col_path)
    assert back["ctg"].length == cv.length
    assert back["ctg"].n_reads == len(alns)
    assert [c.pos for c in back["ctg"].columns] == [c.pos for c in cv.columns]
    assert (back["ctg"].columns[0].rows == cv.columns[0].rows).all()
    assert (back["ctg"].columns[0].alleles == cv.columns[0].alleles).all()

    spans = [(a.t_start, a.t_end) for a in alns]
    groups = separate_reads_for_contig(cv, spans)
    gro_path = str(tmp_path / "groups.gro")
    write_gro(gro_path, {"ctg": groups}, {"ctg": alns}, names)
    gback = read_gro(gro_path)
    assert len(gback["ctg"].windows) == len(groups.windows)
    for w1, w2 in zip(groups.windows, gback["ctg"].windows):
        assert (w1.start, w1.end) == (w2.start, w2.end)
        assert (w1.labels == w2.labels).all()


def test_sam_roundtrip(tmp_path, rng):
    consensus, sim, alns, read_seqs = _dataset(rng)
    names = {i: n for i, n in enumerate(sim.names)}
    sam_path = str(tmp_path / "aln.sam")
    write_sam(sam_path, alns, {"ctg": len(consensus)}, names, read_seqs)
    back = parse_sam(sam_path, {n: i for i, n in names.items()})
    assert len(back) == len(alns)
    for a, b in zip(sorted(alns, key=lambda a: a.read_idx), sorted(back, key=lambda a: a.read_idx)):
        assert (a.contig, a.strand, a.t_start, a.t_end) == (b.contig, b.strand, b.t_start, b.t_end)
        assert a.cigar == b.cigar
