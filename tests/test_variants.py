import numpy as np
import pytest

from hairsplitter_jax.constants import GAP, TRIMER_ABSENT, encode_seq, trimer_central
from hairsplitter_jax.core.mapping import map_reads
from hairsplitter_jax.io.cigar import parse_cigar
from hairsplitter_jax.core.datatypes import Alignment
from hairsplitter_jax.ops.variants import column_stats, suspect_mask
from hairsplitter_jax.pipeline.call_variants import (
    VariantCallConfig,
    call_variants_for_contig,
    pooled_error_rate,
)
from hairsplitter_jax.pipeline.pileup import alignment_cells, build_window_blocks
from hairsplitter_jax.utils.sim import make_haplotypes, mutate, simulate_reads


def _mk_aln(cig, t_start=0, q_start=0, strand=1, read_idx=0, contig="c"):
    ops, lens = parse_cigar(cig)
    from hairsplitter_jax.io.cigar import cigar_query_len, cigar_target_len

    return Alignment(
        read_idx=read_idx,
        contig=contig,
        strand=strand,
        q_start=q_start,
        q_end=q_start + cigar_query_len(ops, lens),
        t_start=t_start,
        t_end=t_start + cigar_target_len(ops, lens),
        cigar_ops=ops,
        cigar_lens=lens,
    )


def test_alignment_cells_match():
    aln = _mk_aln("4=", t_start=2)
    codes = encode_seq("ACGT")
    tpos, tri = alignment_cells(aln, codes)
    assert tpos.tolist() == [2, 3, 4, 5]
    assert trimer_central(tri).tolist() == [0, 1, 2, 3]


def test_alignment_cells_indels():
    # 2 match, 1 del (contig pos skipped in read), 1 ins (no cell), 2 match
    aln = _mk_aln("2=1D1I2=")
    codes = encode_seq("ACGTT")  # read bases
    tpos, tri = alignment_cells(aln, codes)
    # cells at contig pos 0,1 (AC), 2 (deletion '-'), 3,4 (TT; G was inserted)
    assert tpos.tolist() == [0, 1, 2, 3, 4]
    cents = trimer_central(tri).tolist()
    assert cents == [0, 1, GAP, 3, 3]
    # context of the cell after deletion: prev1='-', prev2='C' -> distinct code
    assert tri[3] == 3 * 25 + GAP * 5 + 1


def test_column_stats_and_suspect():
    # 12 reads: 7 allele A(code 0...), 5 allele T, at column 5; elsewhere A
    R, P = 12, 512
    tri = np.full((R, P), TRIMER_ABSENT, dtype=np.int8)
    tri[:, :10] = 0  # all 'AAA' trimers
    alt = np.int8(3 * 25)  # central T
    tri[7:, 5] = alt
    tc, tn, cov = column_stats(tri)
    tc, tn, cov = np.asarray(tc), np.asarray(tn), np.asarray(cov)
    assert cov[5] == 12 and cov[0] == 12 and cov[100] == 0
    assert tc[5, 0] == 0 and tn[5, 0] == 7
    assert tc[5, 1] == alt and tn[5, 1] == 5
    # suspect: c2=5 must be > min_reads=5 -> fails with 5, passes with min 3
    sus5, _ = suspect_mask(tc.astype(np.int32), tn.astype(np.int32), np.int32(5), np.float32(0.33))
    sus3, auto3 = suspect_mask(tc.astype(np.int32), tn.astype(np.int32), np.int32(3), np.float32(0.33))
    assert not bool(np.asarray(sus5)[5])
    assert bool(np.asarray(sus3)[5])
    assert bool(np.asarray(auto3)[5])  # 5 > 0.33*7


def test_homopolymer_indel_not_suspect():
    # second allele is a deletion whose context bases equal the majority base
    R, P = 20, 512
    tri = np.full((R, P), TRIMER_ABSENT, dtype=np.int8)
    tri[:, :10] = 0  # 'AAA'
    # deletion allele '-' with context prev1=A, prev2=A at col 5
    tri[12:, 5] = np.int8(GAP * 25 + 0 * 5 + 0)
    tc, tn, cov = column_stats(tri)
    sus, _ = suspect_mask(
        np.asarray(tc).astype(np.int32), np.asarray(tn).astype(np.int32), np.int32(5), np.float32(0.33)
    )
    assert not bool(np.asarray(sus)[5])
    # but a deletion in a non-homopolymer context is fine
    tri[12:, 5] = np.int8(GAP * 25 + 1 * 5 + 1)  # context C,C vs majority A
    tc, tn, cov = column_stats(tri)
    sus, _ = suspect_mask(
        np.asarray(tc).astype(np.int32), np.asarray(tn).astype(np.int32), np.int32(5), np.float32(0.33)
    )
    assert bool(np.asarray(sus)[5])


def _phase_dataset(rng, length=6000, n_snps=None, cov=12, err=0.0):
    consensus = make_haplotypes(length, 1, 0.001, rng)[0]
    hap2, snp_pos = mutate(consensus, 0.005, rng)
    haps = [consensus, hap2]
    sim = simulate_reads(
        haps, coverage=cov, read_len=1500, rng=rng,
        sub_rate=err, ins_rate=err / 2, del_rate=err / 2,
    )
    alns = map_reads({"ctg": consensus}, sim.seqs)
    read_seqs = {i: s for i, s in enumerate(sim.seqs)}
    return consensus, snp_pos, sim, alns, read_seqs


def test_call_variants_clean(rng):
    consensus, snp_pos, sim, alns, read_seqs = _phase_dataset(rng)
    cv = call_variants_for_contig("ctg", consensus, alns, read_seqs)
    called = {c.pos for c in cv.columns}
    true = set(int(p) for p in snp_pos)
    # with error-free reads every well-covered true SNP should be found
    # (inside the coverage ramp-up of one read length at each contig end)
    interior = {p for p in true if 800 < p < len(consensus) - 800}
    found = len(called & interior)
    assert found >= 0.9 * len(interior), (sorted(interior), sorted(called))
    # and there should be no wild excess of false positives
    assert len(called - true) <= 0.3 * len(true) + 2
    assert cv.error_rate < 0.01
    assert cv.depth > 8


def test_call_variants_noisy(rng):
    # chi2 thresholds (15/20, from the reference) imply realistic coverage;
    # at ~40x total a 6%-error dataset must still yield most true SNPs
    consensus, snp_pos, sim, alns, read_seqs = _phase_dataset(rng, err=0.06, cov=20)
    cv = call_variants_for_contig("ctg", consensus, alns, read_seqs)
    called = {c.pos for c in cv.columns}
    true = set(int(p) for p in snp_pos)
    interior = {p for p in true if 800 < p < len(consensus) - 800}
    near_true = {p for p in called if any(abs(p - t) <= 2 for t in true)}
    assert len(near_true) >= 0.6 * len(interior)
    assert 0.02 < cv.error_rate <= 0.15
    ctgs = [cv]
    assert 0.0 < pooled_error_rate(ctgs) <= 0.15


def test_partition_recurrence_filters_random_noise(rng):
    # no true SNPs: random sequencing errors must mostly be filtered out
    consensus = make_haplotypes(6000, 1, 0.001, rng)[0]
    sim = simulate_reads([consensus], coverage=20, read_len=1500, rng=rng, sub_rate=0.05)
    alns = map_reads({"ctg": consensus}, sim.seqs)
    read_seqs = {i: s for i, s in enumerate(sim.seqs)}
    cv = call_variants_for_contig("ctg", consensus, alns, read_seqs)
    # random errors shouldn't produce recurring partitions
    assert len(cv.columns) <= 10, [c.pos for c in cv.columns]


def test_column_stats_host_twin_matches_device(rng):
    """Numpy twins must be bit-identical to the jitted ops (they take over on
    small windows to avoid per-shape device compiles)."""
    import numpy as np

    from hairsplitter_jax.constants import TRIMER_ABSENT
    from hairsplitter_jax.ops.variants import (
        column_stats,
        column_stats_host,
        window_error_stats,
        window_error_stats_host,
    )

    R, P = 37, 512
    tri = rng.integers(0, 125, (R, P)).astype(np.int8)
    tri[rng.random((R, P)) < 0.4] = TRIMER_ABSENT
    codes_w = rng.integers(0, 5, P).astype(np.int8)
    tc_d, tn_d, cov_d = (np.asarray(x) for x in column_stats(tri))
    tc_h, tn_h, cov_h = column_stats_host(tri)
    assert np.array_equal(tc_d, tc_h)
    assert np.array_equal(tn_d, tn_h)
    assert np.array_equal(cov_d, cov_h)
    mm_d, cc_d = (int(x) for x in window_error_stats(tri, codes_w))
    assert (mm_d, cc_d) == window_error_stats_host(tri, codes_w)


def test_packed_correlation_matches_unpacked():
    """The bit-packed transfer variants of the stage-3 device kernels are
    bit-identical to the f32 versions (same math after on-device unpack)."""
    import numpy as np

    from hairsplitter_jax.ops.variants import (
        pairwise_column_correlation,
        pairwise_column_correlation_packed,
        partition_column_keep,
        partition_column_keep_packed,
        partition_rescue_keep,
        partition_rescue_keep_packed,
    )

    rng = np.random.default_rng(0)
    S, n = 64, 64
    A = (rng.random((S, n)) < 0.25).astype(np.uint8)
    R = ((rng.random((S, n)) < 0.5) & (A == 0)).astype(np.uint8)
    pos = np.sort(rng.integers(0, 10000, S)).astype(np.int64)
    Ap = np.packbits(A, axis=1, bitorder="little")
    Rp = np.packbits(R, axis=1, bitorder="little")
    Af, Rf = A.astype(np.float32), R.astype(np.float32)
    c1, f1 = pairwise_column_correlation(Af, Rf, pos, np.float32(15.0), np.int64(5000))
    c2, f2 = pairwise_column_correlation_packed(Ap, Rp, pos, np.float32(15.0), np.int64(5000))
    assert np.array_equal(np.asarray(c1), np.asarray(c2))
    assert np.array_equal(np.asarray(f1), np.asarray(f2))
    K = 8
    P1 = (rng.random((K, n)) < 0.3).astype(np.float32)
    P0 = (rng.random((K, n)) < 0.5).astype(np.float32)
    cs = rng.integers(1, n, S).astype(np.float32)
    k1 = partition_column_keep(P1, P0, Af, Rf, cs, np.float32(15.0))
    k2 = partition_column_keep_packed(P1, P0, Ap, Rp, cs, np.float32(15.0))
    assert np.array_equal(np.asarray(k1), np.asarray(k2))
    r1 = partition_rescue_keep(P1, P0, Af, Rf, np.float32(20.0))
    r2 = partition_rescue_keep_packed(P1, P0, Ap, Rp, np.float32(20.0))
    assert np.array_equal(np.asarray(r1), np.asarray(r2))


def test_auto_frac_rescues_high_frequency_snps():
    """-u/auto_frac (reference `call_variants.cpp:531,1334-1352`): columns
    whose second allele reaches the -u frequency are kept AUTOMATICALLY,
    even when correlation filtering would drop them (a single isolated SNP
    has nothing to correlate with)."""
    import numpy as np

    from hairsplitter_jax.constants import encode_seq
    from hairsplitter_jax.core.datatypes import Alignment
    from hairsplitter_jax.pipeline.call_variants import (
        VariantCallConfig,
        call_variants_from_prep,
        finish_preps,
        prepare_contig_host,
    )
    from hairsplitter_jax.utils.sim import random_genome

    rng = np.random.default_rng(3)
    contig = random_genome(4000, rng)
    # 20 reads: half carry ONE isolated substitution at position 2000
    codes = encode_seq(contig)
    alt = (codes[2000] + 1) % 4
    reads, alns = {}, []
    for r in range(20):
        rc = codes.copy()
        if r % 2 == 0:
            rc[2000] = alt
        from hairsplitter_jax.constants import decode_seq

        reads[r] = decode_seq(rc)
        alns.append(
            Alignment(
                read_idx=r, contig="c", strand=1, q_start=0, q_end=4000,
                t_start=0, t_end=4000, nm=1 if r % 2 == 0 else 0,
                cigar_ops=np.array([0], np.int8),
                cigar_lens=np.array([4000], np.int64),
            )
        )
    cfg = VariantCallConfig(auto_frac=0.33)
    prep = prepare_contig_host("c", contig, alns, reads, cfg)
    preps = finish_preps([prep], cfg)
    cv = call_variants_from_prep(preps["c"], 0.02, cfg)
    # the lone 50%-frequency SNP is kept (automatic keep at -u 0.33; a
    # clean balanced column also stands on its own in the robust filter)
    assert any(c.pos == 2000 for c in cv.columns), [c.pos for c in cv.columns]
    # and nothing spurious was called elsewhere
    assert all(c.pos == 2000 for c in cv.columns), [c.pos for c in cv.columns]
