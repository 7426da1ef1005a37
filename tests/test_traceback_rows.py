"""Bit-exactness of the row-lockstep device traceback.

The production mapping path is `ops.align_device.align_traceback_rows`
(DP kernel + readout + row-lockstep traceback in one device call) decoded by
`expand_rows_host` (native C++ or numpy). Everything here is proven equal to
the host pair `ops.align.readout` + `ops.align.traceback_batch` element for
element, across band shapes, edge jobs and decoders.
"""

import numpy as np
import pytest

from hairsplitter_jax.ops.align import (
    BandSpec,
    Q_SENTINEL,
    T_SENTINEL,
    banded_align_batch,
    readout,
    traceback_batch,
)
from hairsplitter_jax.ops.align_device import align_traceback_rows, expand_rows_host


def random_batch(rng, n, spec, mutate=0.15):
    """n sentinel-padded DP jobs of mixed kinds: empty queries, identical
    pairs, unrelated pairs and mutated copies with indels."""
    B, T = spec.chunk, spec.t_width
    q = np.full((n, B), Q_SENTINEL, dtype=np.int8)
    t = np.full((n, T), T_SENTINEL, dtype=np.int8)
    qlens = np.zeros(n, dtype=np.int32)
    tlens = np.zeros(n, dtype=np.int32)
    for i in range(n):
        kind = rng.integers(0, 6)
        ql = int(rng.integers(0, B + 1))
        if kind == 0:  # empty query
            ql = 0
        base = rng.integers(0, 4, size=max(ql, 1)).astype(np.int8)
        if kind == 1:  # identical
            tl = ql
            tseq = base[:ql].copy()
        elif kind == 2:  # unrelated
            tl = int(rng.integers(0, T + 1))
            tseq = rng.integers(0, 4, size=tl).astype(np.int8)
        else:  # mutated copy with indels
            tseq = []
            for c in base[:ql]:
                r = rng.random()
                if r < mutate / 3:
                    continue  # deletion
                if r < 2 * mutate / 3:
                    tseq.append(int(rng.integers(0, 4)))  # substitution
                else:
                    tseq.append(int(c))
                if rng.random() < mutate / 3:
                    tseq.append(int(rng.integers(0, 4)))  # insertion
            tseq = np.asarray(tseq[:T], dtype=np.int8)
            tl = len(tseq)
        q[i, :ql] = base[:ql]
        t[i, :tl] = tseq[:tl]
        qlens[i] = ql
        tlens[i] = tl
    return q, qlens, t, tlens


def _reference(q, qlens, t, tlens, modes, spec):
    ref = {k: np.asarray(v) for k, v in banded_align_batch(q, qlens, t, tlens, spec).items()}
    cost, si, sb, clip = readout(ref, qlens, tlens, modes, spec)
    ops = traceback_batch(ref["bp"], q, t, si, sb, spec)
    return ops, cost, clip


def _check(spec, n, seed):
    rng = np.random.default_rng(seed)
    q, qlens, t, tlens = random_batch(rng, n, spec)
    modes = (np.arange(n) % 2).astype(np.int32)
    ops_r, cost_r, clip_r = _reference(q, qlens, t, tlens, modes, spec)
    fused = align_traceback_rows(q, qlens, t, tlens, modes, spec)
    ops_g, cost_g, clip_g = expand_rows_host(fused, q, t, spec)
    np.testing.assert_array_equal(cost_g, cost_r)
    np.testing.assert_array_equal(clip_g, clip_r)
    for i in range(n):
        np.testing.assert_array_equal(ops_g[i], ops_r[i], err_msg=f"alignment {i}")


@pytest.mark.parametrize(
    "spec,n,seed",
    [
        (BandSpec(chunk=48, band=32), 96, 0),
        (BandSpec(chunk=64, band=64), 96, 1),
        (BandSpec(chunk=256, band=128), 32, 2),
    ],
)
def test_rows_traceback_jnp_kernel(spec, n, seed):
    _check(spec, n, seed)


def _edge_jobs(spec):
    """Jobs at the edges of the DP: empty query, all-sentinel (gap) target,
    empty both, qlen == B exactly, target longer than the query, and an
    unrelated pair; run in both modes."""
    B, T = spec.chunk, spec.t_width
    rng = np.random.default_rng(13)
    base = rng.integers(0, 4, B).astype(np.int8)
    cases = [
        (base[:0], base[:40]),  # empty query
        (base[:40], base[:0]),  # all-gap target
        (base[:0], base[:0]),
        (base, base),  # qlen == B, identical
        (base, np.roll(base, 3)),  # qlen == B, shifted
        (base[:50], rng.integers(0, 4, T).astype(np.int8)),  # long unrelated target
        (base[:B - 1], np.concatenate([base[:60], base[70:]])),  # deletion run
        (base, np.insert(base, 30, base[:20])[:T]),  # insertion run
    ]
    n = 2 * len(cases)
    q = np.full((n, B), 7, np.int8)
    t = np.full((n, T), 6, np.int8)
    ql = np.zeros(n, np.int32)
    tl = np.zeros(n, np.int32)
    modes = np.zeros(n, np.int32)
    for k, (qq, tt) in enumerate(cases * 2):
        q[k, : qq.size] = qq
        t[k, : tt.size] = tt
        ql[k], tl[k] = qq.size, tt.size
        modes[k] = k // len(cases)  # first half global, second extension
    return q, ql, t, tl, modes


@pytest.mark.parametrize("chunk,band", [(64, 128), (128, 128), (256, 128), (48, 32)])
def test_fused_matches_host_on_edge_jobs(chunk, band):
    spec = BandSpec(chunk=chunk, band=band)
    q, ql, t, tl, modes = _edge_jobs(spec)
    got = np.asarray(align_traceback_rows(q, ql, t, tl, modes, spec))
    ops_r, cost_r, clip_r = _reference(q, ql, t, tl, modes, spec)
    ops_g, cost_g, clip_g = expand_rows_host(got, q, t, spec)
    np.testing.assert_array_equal(cost_g, cost_r)
    np.testing.assert_array_equal(clip_g, clip_r)
    for a, b in zip(ops_g, ops_r):
        np.testing.assert_array_equal(a, b)


def test_expand_rows_numpy_matches_native(monkeypatch):
    from hairsplitter_jax import native

    spec = BandSpec(chunk=64, band=64)
    rng = np.random.default_rng(7)
    n = 64
    q, qlens, t, tlens = random_batch(rng, n, spec)
    modes = (np.arange(n) % 2).astype(np.int32)
    fused = np.asarray(align_traceback_rows(q, qlens, t, tlens, modes, spec))

    nat = expand_rows_host(fused, q, t, spec)
    monkeypatch.setattr(native, "expand_rows", lambda *a, **k: None)
    pure = expand_rows_host(fused, q, t, spec)
    np.testing.assert_array_equal(nat[1], pure[1])
    np.testing.assert_array_equal(nat[2], pure[2])
    for a, b in zip(nat[0], pure[0]):
        np.testing.assert_array_equal(a, b)


def test_mapping_device_tb_matches_host_paths():
    """End-to-end: map_reads through the device-traceback bucket path equals
    the pure host path on a small simulated dataset (CPU backend: the device
    path is exercised explicitly via run_jobs' internals)."""
    from hairsplitter_jax.core.mapping import MapConfig, map_reads
    from hairsplitter_jax.core import mapping as mapping_mod
    from hairsplitter_jax.utils.sim import random_genome, simulate_reads

    rng = np.random.default_rng(3)
    genome = random_genome(8000, rng)
    sim = simulate_reads(
        [genome], coverage=4, read_len=1500, rng=rng,
        sub_rate=0.04, ins_rate=0.02, del_rate=0.02,
    )
    cfg = MapConfig()
    base = map_reads({"c": genome}, sim.seqs, cfg)

    # force the device-traceback path even on CPU (jnp kernel inside)
    orig = mapping_mod.run_jobs

    def forced(jobs, c):
        return mapping_mod._run_jobs_device_tb(jobs, c)

    mapping_mod.run_jobs = forced
    try:
        dev = map_reads({"c": genome}, sim.seqs, cfg)
    finally:
        mapping_mod.run_jobs = orig
    assert len(base) == len(dev)
    for a, b in zip(base, dev):
        assert (a.read_idx, a.contig, a.strand, a.q_start, a.q_end, a.t_start, a.t_end, a.nm) == (
            b.read_idx, b.contig, b.strand, b.q_start, b.q_end, b.t_start, b.t_end, b.nm
        )
        np.testing.assert_array_equal(a.cigar_ops, b.cigar_ops)
        np.testing.assert_array_equal(a.cigar_lens, b.cigar_lens)
