"""Stage-level resume, low-memory mode, bluntify, technology presets."""

import os

import numpy as np
import pytest

from hairsplitter_jax.io.fasta import write_fasta
from hairsplitter_jax.io.gfa import AssemblyGraph, Link, bluntify_graph, parse_gfa, write_gfa
from hairsplitter_jax.pipeline.orchestrate import (
    PipelineConfig,
    TECH_PRESETS,
    apply_tech_preset,
    run_pipeline,
)
from hairsplitter_jax.utils.sim import make_haplotypes, mutate, simulate_reads


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    rng = np.random.default_rng(5)
    consensus = make_haplotypes(12_000, 1, 0.001, rng)[0]
    hap2, _ = mutate(consensus, 0.015, rng)
    sim = simulate_reads([consensus, hap2], coverage=15, read_len=3000, rng=rng)
    d = tmp_path_factory.mktemp("data")
    asm = str(d / "assembly.fasta")
    reads = str(d / "reads.fasta")
    write_fasta(asm, {"ctg": consensus})
    write_fasta(reads, {f"r{i}": s for i, s in enumerate(sim.seqs)})
    return asm, reads


def _run(asm, reads, out, **kw):
    cfg = PipelineConfig(**kw)
    return run_pipeline(asm, reads, str(out), cfg)


def test_stage_resume_byte_identical(dataset, tmp_path):
    asm, reads = dataset
    out = tmp_path / "run"
    gfa1 = _run(asm, reads, out, no_clean=True)
    first = open(gfa1).read()
    tmp = out / "tmp"
    # all stage artifacts must exist (COL/GRO now written by the orchestrator)
    for art in ("reads_on_asm.sam", "variants.col", "reads_haplo.gro", "error_rate.txt"):
        assert (tmp / art).exists(), art
    # kill the run "after stage 4": drop the final assembly and stage-5 files
    os.remove(gfa1)
    os.remove(tmp / "zipped_assembly.gfa")
    log_len = len(open(out / "hairsplitter.log").read().splitlines())
    gfa2 = _run(asm, reads, out, no_clean=True, resume=True)
    assert open(gfa2).read() == first
    log = open(out / "hairsplitter.log").read().splitlines()[log_len:]
    joined = "\n".join(log)
    assert "resume: variants loaded" in joined
    assert "resume: read groups loaded" in joined
    assert "STAGE 3 calling variants" not in joined


def test_resume_rejects_changed_params(dataset, tmp_path):
    asm, reads = dataset
    out = tmp_path / "run"
    _run(asm, reads, out, no_clean=True)
    log_len = len(open(out / "hairsplitter.log").read().splitlines())
    _run(asm, reads, out, no_clean=True, resume=True, auto_frac=0.5)
    log = "\n".join(open(out / "hairsplitter.log").read().splitlines()[log_len:])
    assert "parameters changed" in log


def test_low_memory_same_output(dataset, tmp_path):
    asm, reads = dataset
    g1 = _run(asm, reads, tmp_path / "hi")
    g2 = _run(asm, reads, tmp_path / "lo", low_memory=True)
    assert open(g1).read() == open(g2).read()
    stats = (tmp_path / "lo" / "stage_stats.json")
    assert stats.exists() and "mapping" in stats.read_text()


def test_bluntified_input_gfa(tmp_path):
    rng = np.random.default_rng(7)
    a = make_haplotypes(3000, 1, 0.001, rng)[0]
    b = make_haplotypes(3000, 1, 0.001, rng)[0]
    ov = a[-120:]
    g = AssemblyGraph()
    g.add_segment("A", a, 20.0)
    g.add_segment("B", ov + b, 20.0)  # 120 bp overlap duplicated
    g.add_link(Link("A", "+", "B", "+", "120M"))
    n = bluntify_graph(g)
    assert n == 120
    assert all(l.cigar == "0M" for l in g.links)
    assert g.segments["A"] + g.segments["B"] == a + b or g.segments["B"] == b

    # and end-to-end: an overlapping-link GFA round-trips through the pipeline
    sim = simulate_reads([a + b], coverage=12, read_len=1500, rng=rng)
    g2 = AssemblyGraph()
    g2.add_segment("A", a, 20.0)
    g2.add_segment("B", ov + b, 20.0)
    g2.add_link(Link("A", "+", "B", "+", "120M"))
    gfa_in = tmp_path / "ov.gfa"
    write_gfa(g2, str(gfa_in))
    reads = tmp_path / "reads.fasta"
    write_fasta(str(reads), {f"r{i}": s for i, s in enumerate(sim.seqs)})
    out = run_pipeline(str(gfa_in), str(reads), str(tmp_path / "out"), PipelineConfig())
    final = parse_gfa(out)
    total = sum(len(s) for s in final.segments.values())
    assert abs(total - len(a + b)) < 400  # overlap not duplicated in the output


def test_tech_presets_change_mapping():
    base = PipelineConfig()
    hifi = apply_tech_preset(PipelineConfig(technology="hifi"))
    assert hifi.map.k == 19 and hifi.map.w == 19 and not hifi.map.rescue
    ont = apply_tech_preset(PipelineConfig(technology="ont"))
    assert ont.map.k == 15 and ont.map.w == 10
    assert set(TECH_PRESETS) == {"ont", "pacbio", "hifi", "amplicon"}
    assert base.map.k == 15
