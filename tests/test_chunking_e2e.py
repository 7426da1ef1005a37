"""A contig longer than the 300 kb chunk limit must be cut, phased per chunk
and re-threaded (reference `cut_gfa.py` + GraphUnzip re-merge)."""

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
def test_long_contig_chunked_pipeline(tmp_path, rng):
    length = 80_000
    consensus = make_haplotypes(length, 1, 0.001, rng)[0]
    hap2, _ = mutate(consensus, 0.008, rng)
    sim = simulate_reads(
        [consensus, hap2], coverage=12, read_len=6000, rng=rng,
        sub_rate=0.02, ins_rate=0.01, del_rate=0.01,
    )
    asm = AssemblyGraph()
    asm.add_segment("big", consensus, depth=24.0)
    asm_path = str(tmp_path / "a.gfa")
    reads_path = str(tmp_path / "r.fa")
    write_gfa(asm, asm_path)
    write_sim_fasta(reads_path, sim)
    cfg = PipelineConfig(max_contig_chunk=30_000)  # force 3 chunks, scaled down
    final = run_pipeline(asm_path, reads_path, str(tmp_path / "out"), cfg)
    g = parse_gfa(final)
    out_kmers = set()
    for s in g.segments.values():
        out_kmers |= _kmers(s)
        out_kmers |= _kmers(revcomp(s))
    for hap in (consensus, hap2):
        qs = _kmers(hap[3000:77_000], step=7)
        frac = len(qs & out_kmers) / max(1, len(qs))
        assert frac > 0.7, frac
    # chunk boundaries must not break contiguity catastrophically: expect the
    # untangler to re-thread most chunk pieces (far fewer contigs than
    # 2 haplotypes x (length/chunk) x windows)
    assert len(g.segments) < 30, len(g.segments)
