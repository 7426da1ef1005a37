"""Diploid phasing config (BASELINE.json config 3): ONT-like reads on a
haploid assembly with ploidy inferred from -c (haploid coverage)."""

import os

import numpy as np
import pytest

from hairsplitter_jax.constants import revcomp
from hairsplitter_jax.io import parse_gfa, write_gfa
from hairsplitter_jax.io.gfa import AssemblyGraph
from hairsplitter_jax.pipeline.orchestrate import PipelineConfig, run_pipeline
from hairsplitter_jax.utils.sim import make_haplotypes, mutate, simulate_reads, write_sim_fasta


def _kmers(s, k=31, step=1):
    return {s[i : i + k] for i in range(0, len(s) - k + 1, step)}


@pytest.mark.slow
def test_diploid_with_ploidy_cap(tmp_path, rng):
    hap1 = make_haplotypes(20_000, 1, 0.001, rng)[0]
    hap2, _ = mutate(hap1, 0.008, rng)
    sim = simulate_reads(
        [hap1, hap2], coverage=18, read_len=5000, rng=rng,
        sub_rate=0.04, ins_rate=0.02, del_rate=0.02,
    )
    asm = AssemblyGraph()
    asm.add_segment("chrI", hap1, depth=36.0)
    asm_path = str(tmp_path / "asm.gfa")
    reads_path = str(tmp_path / "reads.fa")
    write_gfa(asm, asm_path)
    write_sim_fasta(reads_path, sim)
    out = str(tmp_path / "out")
    final = run_pipeline(
        asm_path, reads_path, out,
        PipelineConfig(haploid_coverage=18.0, no_clean=True),
    )
    # ploidy file written, cap = 2 for the contig
    ploidy_path = os.path.join(out, "tmp", "ploidy.txt")
    assert os.path.exists(ploidy_path)
    mult = dict(l.split("\t") for l in open(ploidy_path).read().splitlines())
    assert int(mult["chrI"]) == 2
    g = parse_gfa(final)
    out_kmers = set()
    for s in g.segments.values():
        out_kmers |= _kmers(s)
        out_kmers |= _kmers(revcomp(s))
    for hap in (hap1, hap2):
        qs = _kmers(hap[2000:18000], step=7)
        frac = len(qs & out_kmers) / max(1, len(qs))
        assert frac > 0.7, frac
    total = sum(len(s) for s in g.segments.values())
    assert total <= 2.4 * 20_000, total
