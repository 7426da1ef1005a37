"""Input robustness: gzipped reads, N bases in the assembly, empty edge cases."""

import gzip

import numpy as np

from hairsplitter_jax.io import parse_gfa, write_gfa
from hairsplitter_jax.io.fasta import ReadStore
from hairsplitter_jax.io.gfa import AssemblyGraph
from hairsplitter_jax.pipeline.orchestrate import PipelineConfig, run_pipeline
from hairsplitter_jax.utils.sim import make_haplotypes, mutate, simulate_reads


def test_gzipped_reads(tmp_path):
    p = str(tmp_path / "r.fasta.gz")
    with gzip.open(p, "wt") as f:
        f.write(">a\nACGTACGT\n>b\nGGGGCCCC\n")
    store = ReadStore(p)
    assert store.names == ["a", "b"]
    assert store.get_seq(1) == "GGGGCCCC"


def test_pipeline_with_n_bases_and_gz_reads(tmp_path, rng):
    consensus = make_haplotypes(4000, 1, 0.001, rng)[0]
    hap2, _ = mutate(consensus, 0.01, rng)
    sim = simulate_reads([consensus, hap2], coverage=12, read_len=1500, rng=rng)
    # poison the assembly with Ns and lowercase
    dirty = consensus[:100] + "NNNN" + consensus[104:2000].lower() + consensus[2000:]
    asm = AssemblyGraph()
    asm.add_segment("ctg", dirty, depth=24)
    asm_path = str(tmp_path / "a.gfa")
    write_gfa(asm, asm_path)
    reads_path = str(tmp_path / "r.fa.gz")
    with gzip.open(reads_path, "wt") as f:
        for n, s in zip(sim.names, sim.seqs):
            f.write(f">{n}\n{s}\n")
    final = run_pipeline(asm_path, reads_path, str(tmp_path / "out"), PipelineConfig())
    g = parse_gfa(final)
    assert g.segments
    total = sum(len(s) for s in g.segments.values())
    assert total > 4000  # separation still happened
    for s in g.segments.values():
        assert set(s) <= set("ACGT"), "output must be sanitized"


def test_resume_reloads_sam(tmp_path, rng):
    import os

    consensus = make_haplotypes(3000, 1, 0.001, rng)[0]
    hap2, _ = mutate(consensus, 0.01, rng)
    sim = simulate_reads([consensus, hap2], coverage=10, read_len=1200, rng=rng)
    asm = AssemblyGraph()
    asm.add_segment("ctg", consensus, depth=20)
    asm_path = str(tmp_path / "a.gfa")
    write_gfa(asm, asm_path)
    reads_path = str(tmp_path / "r.fa")
    from hairsplitter_jax.utils.sim import write_sim_fasta

    write_sim_fasta(reads_path, sim)
    out = str(tmp_path / "out")
    cfg = PipelineConfig(no_clean=True)
    final1 = run_pipeline(asm_path, reads_path, out, cfg)
    g1 = parse_gfa(final1)
    # interrupting after mapping == final gfa missing but SAM present
    os.remove(final1)
    cfg2 = PipelineConfig(no_clean=True, resume=True)
    final2 = run_pipeline(asm_path, reads_path, out, cfg2)
    g2 = parse_gfa(final2)
    assert sorted(len(s) for s in g1.segments.values()) == sorted(
        len(s) for s in g2.segments.values()
    )
    log = open(os.path.join(out, "hairsplitter.log")).read()
    assert "resume:" in log and "alignments loaded" in log
