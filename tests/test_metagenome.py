"""Mock metagenome config (BASELINE.json config 4): several species, 2-3
strains each, HiFi-like reads, strain recovery across a multi-contig assembly."""

import numpy as np
import pytest

from hairsplitter_jax.constants import revcomp
from hairsplitter_jax.io import parse_gfa, write_gfa
from hairsplitter_jax.io.gfa import AssemblyGraph
from hairsplitter_jax.pipeline.orchestrate import PipelineConfig, run_pipeline
from hairsplitter_jax.utils.sim import SimReads, make_haplotypes, mutate, random_genome, write_sim_fasta


def _kmers(s, k=31, step=1):
    return {s[i : i + k] for i in range(0, len(s) - k + 1, step)}


@pytest.mark.slow
def test_mock_metagenome(tmp_path, rng):
    # 4 species of 15kb; species 0,1 have 2 strains, species 2 has 3, species
    # 3 is clonal. Assembly = one collapsed contig per species.
    species = []
    n_strains = [2, 2, 3, 1]
    for ns in n_strains:
        base = random_genome(15_000, rng)
        strains = [base] + [mutate(base, 0.01, rng)[0] for _ in range(ns - 1)]
        species.append(strains)

    asm = AssemblyGraph()
    names, seqs, haps, starts, strands = [], [], [], [], []
    ridx = 0
    for si, strains in enumerate(species):
        asm.add_segment(f"sp{si}", strains[0], depth=15.0 * len(strains))
        for hi, strain in enumerate(strains):
            # HiFi-like: long accurate reads
            n_reads = int(np.ceil(15 * len(strain) / 6000))
            for _ in range(n_reads):
                s = int(rng.integers(0, max(1, len(strain) - 6000)))
                frag = strain[s : s + 6000]
                if rng.random() < 0.5:
                    frag = revcomp(frag)
                names.append(f"r{ridx}_s{si}h{hi}")
                seqs.append(frag)
                ridx += 1
    sim = SimReads(names, seqs, [0] * len(seqs), [0] * len(seqs), [1] * len(seqs))
    asm_path = str(tmp_path / "asm.gfa")
    reads_path = str(tmp_path / "reads.fa")
    write_gfa(asm, asm_path)
    write_sim_fasta(reads_path, sim)

    final = run_pipeline(asm_path, reads_path, str(tmp_path / "out"), PipelineConfig(technology="hifi"))
    g = parse_gfa(final)
    out_kmers = set()
    for s in g.segments.values():
        out_kmers |= _kmers(s)
        out_kmers |= _kmers(revcomp(s))
    # every strain of every species must be recovered in its interior
    for si, strains in enumerate(species):
        for hi, strain in enumerate(strains):
            region = strain[2000:13000]
            qs = _kmers(region, step=7)
            frac = len(qs & out_kmers) / max(1, len(qs))
            assert frac > 0.7, (si, hi, frac)
    # clonal species must NOT be duplicated: total length sanity
    total = sum(len(s) for s in g.segments.values())
    n_strain_total = sum(n_strains)
    assert total <= (n_strain_total + 1) * 15_000, total
    assert total >= (n_strain_total - 1) * 15_000 * 0.8, total
