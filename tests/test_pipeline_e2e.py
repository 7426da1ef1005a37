import os

import numpy as np
import pytest

from hairsplitter_jax.io import parse_gfa, write_gfa, write_fasta
from hairsplitter_jax.io.gfa import AssemblyGraph
from hairsplitter_jax.pipeline.orchestrate import PipelineConfig, run_pipeline
from hairsplitter_jax.pipeline.unzip import (
    count_link_support,
    duplicate_contigs,
    merge_linear_chains,
    unzip,
)
from hairsplitter_jax.io.gfa import Link
from hairsplitter_jax.utils.sim import make_haplotypes, mutate, simulate_reads, write_sim_fasta


def _identity(a: str, b: str) -> float:
    """Quick identity via shared 21-mers (containment of a in b)."""
    k = 21
    if len(a) < k or len(b) < k:
        return 0.0
    ka = {a[i : i + k] for i in range(len(a) - k + 1)}
    kb = {b[i : i + k] for i in range(len(b) - k + 1)}
    return len(ka & kb) / max(1, len(ka))


def test_unzip_duplicates_shared_contig():
    # A > shared > B  and  C > shared > D, shared must be duplicated
    g = AssemblyGraph()
    for n in "ABCD":
        g.add_segment(n, "ACGT" * 300, depth=10)
    g.add_segment("S", "TTTT" * 300, depth=20)
    g.add_link(Link("A", "+", "S", "+"))
    g.add_link(Link("C", "+", "S", "+"))
    g.add_link(Link("S", "+", "B", "+"))
    g.add_link(Link("S", "+", "D", "+"))
    read_paths = {}
    ridx = 0
    for _ in range(5):
        read_paths[ridx] = [("A", 1), ("S", 1), ("B", 1)]
        ridx += 1
        read_paths[ridx] = [("C", 1), ("S", 1), ("D", 1)]
        ridx += 1
    res = unzip(g, read_paths)
    # after duplication + merging we expect two linear supercontigs A-S-B, C-S-D
    comps = sorted(
        tuple(n.split("-copy")[0] for n, o in comp) for comp in res.supercontigs.values()
    )
    assert comps == [("A", "S", "B"), ("C", "S", "D")], comps
    total_depth = sum(res.graph.depths.values())
    assert total_depth > 0


def test_unzip_keeps_unsupported_when_no_alternative():
    g = AssemblyGraph()
    g.add_segment("A", "ACGT" * 100)
    g.add_segment("B", "TGCA" * 100)
    g.add_link(Link("A", "+", "B", "+"))
    res = unzip(g, {0: [("A", 1)]})
    # the only link has no read support but no alternative either: keep, merge
    assert len(res.graph.segments) == 1


@pytest.mark.slow
def test_full_pipeline_two_strains(tmp_path, rng):
    # collapsed assembly = haplotype 1; reads from two strains at 1% divergence
    length = 12000
    consensus = make_haplotypes(length, 1, 0.001, rng)[0]
    hap2, snp_pos = mutate(consensus, 0.01, rng)
    sim = simulate_reads(
        [consensus, hap2], coverage=20, read_len=3000, rng=rng,
        sub_rate=0.02, ins_rate=0.01, del_rate=0.01,
    )
    asm = AssemblyGraph()
    asm.add_segment("ctg", consensus, depth=40.0)
    asm_path = str(tmp_path / "assembly.gfa")
    write_gfa(asm, asm_path)
    reads_path = str(tmp_path / "reads.fasta")
    write_sim_fasta(reads_path, sim)
    out = str(tmp_path / "out")

    final_gfa = run_pipeline(asm_path, reads_path, out, PipelineConfig())
    g = parse_gfa(final_gfa)
    assert g.segments, "no output contigs"
    total = sum(len(s) for s in g.segments.values())
    # expect roughly two haplotype copies of the (well-covered) genome
    assert total > 1.5 * length, f"total output {total} for genome {length}"
    # each output contig should match one of the two haplotypes very well
    for name, seq in g.segments.items():
        if len(seq) < 500:
            continue
        id1 = _identity(seq, consensus)
        id2 = _identity(seq, hap2)
        assert max(id1, id2) > 0.9, (name, len(seq), id1, id2)
    # and both haplotypes should be represented among the large contigs
    large = [s for s in g.segments.values() if len(s) > 0.5 * length]
    assert large, [len(s) for s in g.segments.values()]
    best = [int(_identity(s, hap2) > _identity(s, consensus)) for s in large]
    assert 0 in best and 1 in best, f"haplotype assignment of large contigs: {best}"
    # pipeline artifacts exist
    assert os.path.exists(os.path.join(out, "hairsplitter_summary.txt"))
    assert os.path.exists(os.path.join(out, "variants.vcf"))
    assert os.path.exists(os.path.join(out, "tmp", "zipped_assembly.gfa"))


def test_hifi_preset_end_to_end(tmp_path, rng):
    """-x hifi runs the whole pipeline with the HiFi seeding preset
    (k19/w19, no rescue pass — low-error reads need no dense re-seeding)
    and still phases a diploid mix perfectly at 1% read error."""
    from hairsplitter_jax.constants import revcomp
    from hairsplitter_jax.io.fasta import write_fasta
    from hairsplitter_jax.io.gfa import parse_gfa
    from hairsplitter_jax.pipeline.orchestrate import PipelineConfig, run_pipeline
    from hairsplitter_jax.utils.sim import make_haplotypes, mutate, simulate_reads, write_sim_fasta

    hap1 = make_haplotypes(15_000, 1, 0.001, rng)[0]
    hap2, _ = mutate(hap1, 0.01, rng)
    sim = simulate_reads(
        [hap1, hap2], coverage=12, read_len=6000, rng=rng,
        sub_rate=0.006, ins_rate=0.002, del_rate=0.002, uniform_edges=True,
    )
    asm = str(tmp_path / "asm.fa")
    rd = str(tmp_path / "reads.fa")
    write_fasta(asm, {"chrI": hap1})
    write_sim_fasta(rd, sim)
    final = run_pipeline(asm, rd, str(tmp_path / "out"), PipelineConfig(technology="hifi"))
    g = parse_gfa(final)

    def kmers(s, k=31, step=1):
        return {s[i : i + k] for i in range(0, len(s) - k + 1, step)}

    ok = set()
    for s in g.segments.values():
        ok |= kmers(s)
        ok |= kmers(revcomp(s))
    for hap in (hap1, hap2):
        qs = kmers(hap[500:14500], step=7)
        assert len(qs & ok) / len(qs) > 0.97, len(qs & ok) / len(qs)
