"""Independent-evidence quality (round-5 #3, round-4 verdict weak #1).

`utils/sim2.py` shares no code or error model with `utils/sim.py` (Python
`random` instead of numpy, log-normal lengths, per-read quality, Markov
error bursts, hp run-length resampling, junk reads). The pipeline's
headline behaviors must hold on its reads too.
"""

import numpy as np
import pytest

from hairsplitter_jax.io.fasta import write_fasta
from hairsplitter_jax.io.gfa import parse_gfa
from hairsplitter_jax.pipeline.orchestrate import PipelineConfig, run_pipeline
from hairsplitter_jax.utils import sim2
from hairsplitter_jax.utils.evaluate import evaluate_phasing
from hairsplitter_jax.utils.sim import make_haplotypes


def test_sim2_reads_have_independent_properties():
    rng = np.random.default_rng(0)
    haps = make_haplotypes(30_000, 1, 0.01, rng)
    reads = sim2.generate(haps, coverage=10.0, seed=3)
    lens = np.array([len(s) for s in reads.seqs])
    # log-normal spread, not fixed-length
    assert lens.std() > 0.15 * lens.mean()
    assert (lens >= 500).all()
    # junk reads present and labeled
    assert any(h == -1 for h in reads.hap_of_read) or len(reads.seqs) < 50
    # coverage roughly on target
    total = sum(len(s) for s in reads.seqs)
    assert 0.8 < total / (10.0 * 30_000) < 1.3


@pytest.mark.slow
def test_sim2_diploid_split(tmp_path):
    rng = np.random.default_rng(5)
    haps = make_haplotypes(50_000, 2, 0.01, rng)
    reads = sim2.generate(haps, coverage=15.0, seed=7)
    asm = str(tmp_path / "a.fa")
    rd = str(tmp_path / "r.fa")
    write_fasta(asm, {"collapsed": haps[0]})
    sim2.write_fasta(rd, reads)
    final = run_pipeline(asm, rd, str(tmp_path / "out"), PipelineConfig())
    ev = evaluate_phasing(parse_gfa(final).segments, haps)
    assert min(ev.haplotype_recovery) >= 0.97, ev.haplotype_recovery
    assert ev.total_switch_errors == 0


def test_hp_deletion_guard_blocks_runlength_miscalls():
    """Deletion alleles inside contig homopolymer runs are never called as
    variants (they are run-length miscalls — the dominant systematic
    long-read error; with sim2's hp model they flooded the robust filter
    3802-strong before the guard)."""
    from hairsplitter_jax.constants import GAP

    from hairsplitter_jax.pipeline.call_variants import call_variants_for_contig
    # a contig with a long homopolymer; reads all undercall it
    core = "ACGTCCGATG" * 20
    contig = core + "A" * 8 + core[::-1]
    reads = {}
    for i in range(30):
        # half the reads drop one A from the run
        run = "A" * (7 if i % 2 == 0 else 8)
        reads[i] = core + run + core[::-1]
    from hairsplitter_jax.core.mapping import MapConfig, map_reads

    alns = map_reads({"c": contig}, [reads[i] for i in range(30)], MapConfig())
    cv = call_variants_for_contig("c", contig, alns, reads, mean_error_hint=0.05)
    run_start = len(core)
    for c in cv.columns:
        in_run = run_start - 1 <= c.pos <= run_start + 8
        is_del = (c.top2 // 25) == GAP
        assert not (in_run and is_del), f"hp run-length deletion called at {c.pos}"
