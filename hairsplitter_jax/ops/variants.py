"""Device ops for pileup column statistics and suspect-variant calling.

Batched JAX reformulation of the reference's per-column counting loops
(`src/call_variants.cpp:447-567`): the pileup window is a dense
[reads, positions] tensor of trimer codes; per-column allele counts are a
fused compare-reduce; the suspect rules are vectorized masks. Positions are
processed in fixed-size windows so memory stays bounded regardless of contig
length (the reference's 300 kb chunking / sparse columns serve the same role).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import GAP, N_TRIMERS, TRIMER_ABSENT

_TILE = 512  # position tile inside the counting kernel


@jax.jit
def column_stats(tri: jnp.ndarray):
    """Per-column top-3 allele statistics of a pileup window.

    tri: int8 [R, P] trimer codes, TRIMER_ABSENT where the read is absent.
    Returns (top_codes int32 [P,3], top_counts int32 [P,3], coverage int32 [P]).
    Ties are broken toward the smaller code (deterministic, unlike the
    reference's hash-map ordering)."""
    R, P = tri.shape
    tiles = P // _TILE if P % _TILE == 0 else -1
    assert tiles > 0, "window length must be a multiple of the position tile"

    codes = jnp.arange(N_TRIMERS, dtype=jnp.int8)

    def tile_stats(t):  # t: [R, _TILE]
        counts = jnp.sum(
            (t[:, :, None] == codes[None, None, :]), axis=0, dtype=jnp.int32
        )  # [_TILE, 125]
        # stable top-3 by (count desc, code asc): subtract a tiny code-rank
        key = counts * N_TRIMERS - jnp.arange(N_TRIMERS, dtype=jnp.int32)[None, :]
        topk, topi = jax.lax.top_k(key, 3)
        top_counts = jnp.take_along_axis(counts, topi, axis=1)
        return topi, top_counts

    tri_tiles = tri.reshape(R, tiles, _TILE).transpose(1, 0, 2)  # [tiles, R, _TILE]
    topi, topc = jax.lax.map(tile_stats, tri_tiles)
    coverage = jnp.sum(tri != TRIMER_ABSENT, axis=0, dtype=jnp.int32)
    return topi.reshape(P, 3), topc.reshape(P, 3), coverage


def suspect_mask(
    top_codes,  # int32 [P, 3]
    top_counts,  # int32 [P, 3]
    min_reads,  # scalar int32 (5; 3 for HiFi)
    auto_frac,  # scalar f32 (the -u rescue threshold, default 0.33)
    min_reads_low=None,  # lower floor for suspect ADMISSION (robust-filter
    # validated); automatics keep the reference floor. Low-coverage strains
    # (~5x) have private-SNP columns with 4-5 ALT reads that the reference's
    # flat `>5` bar drops before the partition machinery can validate them.
    err_rate=0.0,  # pooled error rate: the low floor adapts to the local
    # noise level (expected same-allele error count per column scales with
    # coverage x error), so high-coverage / high-error columns don't flood
    # the robust filter with chance c2=4 columns (measured: 14%-error
    # bursty reads tripled the kept-column count with the flat low floor)
):
    """Suspect / automatic column masks (reference rules, clean trimer decode).

    Rules (`src/call_variants.cpp:526-531`): second allele count above the
    floor, 5x above the third allele, central bases differ, and no deletion
    allele whose two context bases both equal the majority central base
    (indel-adjacent-to-homopolymer guard). Spacing (>5 bp from the previous
    SNP) is enforced by the host, which sees columns in order.

    Pure elementwise math on tiny [P,3] arrays — runs in numpy on host: a
    device round-trip per window block costs far more than the math."""
    top_codes = np.asarray(top_codes)
    top_counts = np.asarray(top_counts)
    c1, c2, c3 = top_counts[:, 0], top_counts[:, 1], top_counts[:, 2]
    t1, t2 = top_codes[:, 0], top_codes[:, 1]
    central1, central2 = t1 // 25, t2 // 25
    prev1_2, prev2_2 = (t2 // 5) % 5, t2 % 5
    not_homopolymer_indel = (central2 != GAP) | (
        (prev1_2 != central1) & (prev2_2 != central1)
    )
    if min_reads_low is None:
        min_reads_low = min_reads
    base = (central1 != central2) & not_homopolymer_indel
    # low-support admission relaxes the 5x-third-allele dominance rule to
    # 2x: at ~50x coverage the error process alone puts ~1 read on a third
    # allele, so `c2 > 5*c3` silently re-raises the floor to 6 and drops
    # every private column of a ~5x strain before the robust filter can
    # weigh in. Strong (reference-floor) columns keep the 5x rule.
    # The low floor ADAPTS to the column's noise level: ~cov*err/3 errors
    # land on the second allele's central base by chance, so the admission
    # bar is 1.5x that expectation (floored at min_reads_low)
    cov = (c1 + c2 + c3).astype(np.float32)
    noise_floor = np.maximum(
        np.float32(min_reads_low), 1.5 * cov * np.float32(err_rate) / 3.0
    )
    suspect = (c2.astype(np.float32) > noise_floor) & (c2 > 2 * c3) & base
    strong = (c2 > min_reads) & (c2 > 5 * c3) & base
    suspect |= strong
    automatic = strong & (c2.astype(np.float32) > np.float32(auto_frac) * c1.astype(np.float32))
    return suspect, automatic


@jax.jit
def window_error_stats(tri: jnp.ndarray, contig_codes: jnp.ndarray):
    """(mismatched cells, covered cells) of a pileup window vs the contig.

    Mirrors the reference's error-rate accumulation over the MSA
    (`src/call_variants.cpp:252-258,434`): every covered cell whose central
    base differs from the contig base (deletions included) is one error."""
    present = tri != TRIMER_ABSENT
    central = (tri.astype(jnp.int32)) // 25
    mism = present & (central != contig_codes[None, :].astype(jnp.int32))
    return jnp.sum(mism, dtype=jnp.int32), jnp.sum(present, dtype=jnp.int32)


def column_stats_host(tri: np.ndarray):
    """Numpy twin of `column_stats` (bit-identical outputs).

    Small windows lose to device dispatch latency and per-shape compiles;
    the host path keeps stage 3 shape-oblivious."""
    R, P = tri.shape
    t = tri.astype(np.int64)
    t[t == TRIMER_ABSENT] = N_TRIMERS  # trash bin
    flat = np.arange(P, dtype=np.int64) * (N_TRIMERS + 1)
    counts = np.bincount(
        (t + flat[None, :]).ravel(), minlength=P * (N_TRIMERS + 1)
    ).reshape(P, N_TRIMERS + 1)[:, :N_TRIMERS]
    key = counts * N_TRIMERS - np.arange(N_TRIMERS, dtype=np.int64)[None, :]
    topi = np.argsort(-key, axis=1, kind="stable")[:, :3].astype(np.int32)
    topc = np.take_along_axis(counts, topi, axis=1).astype(np.int32)
    coverage = counts.sum(axis=1).astype(np.int32)
    return topi, topc, coverage


def window_error_stats_host(tri: np.ndarray, contig_codes: np.ndarray):
    """Numpy twin of `window_error_stats` (bit-identical outputs)."""
    present = tri != TRIMER_ABSENT
    central = tri.astype(np.int32) // 25
    mism = present & (central != contig_codes[None, :].astype(np.int32))
    return int(mism.sum()), int(present.sum())


# chi² values within this relative distance above a threshold count as ties
# and are not kept. Integer tables land exactly on a threshold (a perfect
# split of n = 15 reads has chi² = 15), and there the last bit of the f32
# device statistic or of the f64 host's would decide either way. The device
# statistic is within 1e-6 of the exact value for every table of fewer than
# 92681 reads (`_chi2_dev`), so outside the band both backends decide alike
# (tests/test_chi2_thresholds.py).
CHI2_TIE_RTOL = 1e-5


def chi2_above(chi, thr):
    """The keep rule of every chi² gate: chi > thr, ties excluded."""
    return chi > thr * (1 + CHI2_TIE_RTOL)


def _chi2_dev(n00, n01, n10, n11):
    """Device Pearson chi² of 2x2 tables of integer-valued f32 counts, equal
    to `pipeline.call_variants._chi2_tables` (0 when a margin is empty).

    Closed form n (n00 n11 - n01 n10)^2 / (r0 r1 c0 c1): the determinant is
    exact in int32 for n < 92681, and every other step is a product or
    quotient of positive numbers, so the f32 result is within a few ulps
    (< 1e-6 relative) of the exact chi² at any such n. The expected-count
    form subtracts nearly equal numbers and loses ~1e-5 at n = 1000."""
    i00, i01, i10, i11 = (x.astype(jnp.int32) for x in (n00, n01, n10, n11))
    det = (i00 * i11 - i01 * i10).astype(jnp.float32)
    n = n00 + n01 + n10 + n11
    denom = ((n00 + n01) * (n10 + n11)) * ((n00 + n10) * (n01 + n11))
    return jnp.where(denom > 0, n * det * det / jnp.maximum(denom, 1.0), 0.0)


def _pack_bool(b):
    """bool [..., M] -> uint8 [..., M//8] (little-endian bit order)."""
    m = b.shape[-1]
    w = jnp.asarray([1, 2, 4, 8, 16, 32, 64, 128], jnp.int32)
    return (
        (b.reshape(*b.shape[:-1], m // 8, 8).astype(jnp.int32) * w)
        .sum(-1)
        .astype(jnp.uint8)
    )


def _unpack_bits_f32(p):
    """uint8 [S, n/8] (little-endian bits) -> f32 0/1 [S, n] on device."""
    bits = (p[:, :, None] >> jnp.arange(8, dtype=jnp.uint8)[None, None, :]) & jnp.uint8(1)
    return bits.reshape(p.shape[0], p.shape[1] * 8).astype(jnp.float32)


@jax.jit
def pairwise_column_correlation_packed(
    Ap, Rp, pos, chi2_keep, max_span, margin=jnp.float32(0.1), margin_min=jnp.float32(0.0)
):
    """`pairwise_column_correlation` taking BIT-PACKED allele indicators:
    the read-axis ships as 1 bit per cell and unpacks on device (the S x R
    f32 matrices cost ~32x the transfer of the packed form)."""
    return pairwise_column_correlation(
        _unpack_bits_f32(Ap), _unpack_bits_f32(Rp), pos, chi2_keep, max_span, margin, margin_min
    )


@jax.jit
def pairwise_column_correlation(
    A, Rf, pos, chi2_keep, max_span, margin=jnp.float32(0.1), margin_min=jnp.float32(0.0)
):
    """Device pairwise column-correlation step of the robust filter
    (reference `keep_only_robust_variants` distance/chi2 scan,
    `src/call_variants.cpp:577-768`): the four S x S contingency matmuls,
    allele-flip phasing, Pearson chi2, balanced-margin and span gates — on
    the MXU, shipping home two packed bit matrices (corr, flip) instead of
    S x S floats. Padded columns have zero indicator rows -> corr False."""
    n11 = A @ A.T
    n10 = A @ Rf.T
    n01 = Rf @ A.T
    n00 = Rf @ Rf.T
    flip = (n11 + n00) < (n10 + n01)
    f11 = jnp.where(flip, n10, n11)
    f10 = jnp.where(flip, n11, n10)
    f01 = jnp.where(flip, n00, n01)
    f00 = jnp.where(flip, n01, n00)
    chi = _chi2_dev(f00, f01, f10, f11)
    comparable = n00 + n01 + n10 + n11
    m1 = f10 + f11
    m2 = f01 + f11
    # margin gate: the reference requires both margins within [0.1, 0.9] of
    # the comparable reads (`call_variants.cpp:606-607`), which rejects every
    # pair of a <=10%-abundance strain's private columns; an absolute floor
    # with a 5% fraction keeps the degenerate-table guard while letting
    # low-abundance partitions form (round-5 low-coverage frontier)
    lo = jnp.maximum(margin_min, margin * comparable)
    balanced = (m1 > lo) & (m1 < comparable - lo) & (m2 > lo) & (m2 < comparable - lo)
    # chance-bridge guard: two truly co-partitioning columns share their
    # whole alt-side read set, so require a minimum absolute agreement on
    # the (phase-aligned) alt side — a chi2-passing pair sharing only 1-2
    # reads is a noise bridge that would transitively merge unrelated
    # partitions in the component step
    balanced &= f11 >= jnp.float32(3.0)
    near = jnp.abs(pos[:, None] - pos[None, :]) <= max_span
    s = A.shape[0]
    eye = jnp.eye(s, dtype=bool)
    corr = chi2_above(chi, chi2_keep) & balanced & near & ~eye
    return _pack_bool(corr), _pack_bool(flip)


@jax.jit
def partition_column_keep_packed(P1, P0, Ap, Rp, col_size, chi2_keep):
    """`partition_column_keep` with bit-packed column indicators (the same
    device-resident packed arrays the correlation call used)."""
    return partition_column_keep(P1, P0, _unpack_bits_f32(Ap), _unpack_bits_f32(Rp), col_size, chi2_keep)


@jax.jit
def partition_column_keep(P1, P0, A, Rf, col_size, chi2_keep):
    """Device final-keep scan: suspect columns correlating with any kept
    partition (chi2 > keep threshold over >half the column's reads),
    reference re-scan at `call_variants.cpp:756`. Returns packed bool [S/8]."""
    k11 = P1 @ A.T
    k10 = P1 @ Rf.T
    k01 = P0 @ A.T
    k00 = P0 @ Rf.T
    chi = _chi2_dev(k00, k01, k10, k11)
    enough = (k00 + k01 + k10 + k11) > 0.5 * col_size[None, :]
    return _pack_bool((chi2_above(chi, chi2_keep) & enough).any(axis=0))


@jax.jit
def partition_rescue_keep_packed(P1, P0, Arp, Rrp, chi2_rescue):
    """`partition_rescue_keep` with bit-packed rescue-column indicators."""
    return partition_rescue_keep(P1, P0, _unpack_bits_f32(Arp), _unpack_bits_f32(Rrp), chi2_rescue)


@jax.jit
def partition_rescue_keep(P1, P0, Ar, Rr, chi2_rescue):
    """Device rescue scan (chi2 > rescue threshold with >4 reads on both
    margin sides, reference rescue of near-suspect columns). Packed bool."""
    r11 = P1 @ Ar.T
    r10 = P1 @ Rr.T
    r01 = P0 @ Ar.T
    r00 = P0 @ Rr.T
    chi = _chi2_dev(r00, r01, r10, r11)
    ok = chi2_above(chi, chi2_rescue) & (r10 + r00 > 4) & (r01 + r11 > 4)
    return _pack_bool(ok.any(axis=0))
