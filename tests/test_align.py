import numpy as np
import pytest

from hairsplitter_jax.constants import decode_seq, encode_seq, revcomp
from hairsplitter_jax.core.mapping import MapConfig, map_reads
from hairsplitter_jax.core.seeding import MinimizerIndex, chain_anchors, find_chains, minimizers
from hairsplitter_jax.io.cigar import OPS, cigar_query_len, cigar_target_len, expand_cigar
from hairsplitter_jax.ops.align import (
    BandSpec,
    Q_SENTINEL,
    T_SENTINEL,
    banded_align_batch,
    readout,
    traceback_batch,
)
from hairsplitter_jax.utils.sim import make_haplotypes, random_genome, simulate_reads


def _align_pair(q, t, mode=0, spec=BandSpec(chunk=64, band=128)):
    qc = encode_seq(q)
    tc = encode_seq(t)
    qb = np.full((1, spec.chunk), Q_SENTINEL, np.int8)
    tb = np.full((1, spec.t_width), T_SENTINEL, np.int8)
    qb[0, : len(qc)] = qc
    tb[0, : len(tc)] = tc
    qlens = np.array([len(qc)], np.int32)
    tlens = np.array([len(tc)], np.int32)
    res = banded_align_batch(qb, qlens, tb, tlens, spec)
    cost, si, sb, clip = readout(res, qlens, tlens, np.array([mode]), spec)
    ops = traceback_batch(np.asarray(res["bp"]), qb, tb, si, sb, spec)[0]
    return int(cost[0]), ops, int(clip[0])


def _levenshtein(a, b):
    m = np.zeros((len(a) + 1, len(b) + 1), dtype=int)
    m[:, 0] = np.arange(len(a) + 1)
    m[0, :] = np.arange(len(b) + 1)
    for i in range(1, len(a) + 1):
        for j in range(1, len(b) + 1):
            m[i, j] = min(
                m[i - 1, j - 1] + (a[i - 1] != b[j - 1]), m[i - 1, j] + 1, m[i, j - 1] + 1
            )
    return int(m[len(a), len(b)])


def _check_ops(q, t, ops, cost, global_mode=True):
    """Walk the expanded ops and verify they replay q against t."""
    qi = ti = nm = 0
    for op in ops:
        o = OPS[op]
        if o == "=":
            assert q[qi] == t[ti], (qi, ti)
            qi += 1
            ti += 1
        elif o == "X":
            assert q[qi] != t[ti]
            qi += 1
            ti += 1
            nm += 1
        elif o == "I":
            qi += 1
            nm += 1
        elif o == "D":
            ti += 1
            nm += 1
    assert qi == len(q)
    if global_mode:
        assert ti == len(t)
    assert nm == cost


def test_exact_match():
    s = "ACGTTGCAACGGTCAT" * 3
    cost, ops, clip = _align_pair(s, s)
    assert cost == 0 and clip == 0
    assert all(OPS[o] == "=" for o in ops)


def test_substitution_and_indels():
    t = "ACGTTGCAACGGTCATACGGATTACA"
    q = "ACGTAGCAACGTCATACGGAGTTACA"  # 1 sub, 1 del, 1 ins
    cost, ops, _ = _align_pair(q, t)
    assert cost == _levenshtein(q, t)
    _check_ops(q, t, ops, cost)


@pytest.mark.parametrize("seed", range(5))
def test_random_vs_levenshtein(seed):
    rng = np.random.default_rng(seed)
    t = random_genome(50, rng)
    # mutate to a query
    q = list(t)
    for _ in range(6):
        p = rng.integers(0, len(q))
        r = rng.random()
        if r < 0.4:
            q[p] = "ACGT"[rng.integers(0, 4)]
        elif r < 0.7 and len(q) > 10:
            q.pop(p)
        else:
            q.insert(p, "ACGT"[rng.integers(0, 4)])
    q = "".join(q)
    cost, ops, _ = _align_pair(q, t)
    assert cost == _levenshtein(q, t)
    _check_ops(q, t, ops, cost)


def test_extension_mode_free_end():
    t = "ACGTTGCAACGGTCATACGGATTACAGGCATTTT"
    q = t[:20]  # query is a prefix; target end must be free
    cost, ops, clip = _align_pair(q, t, mode=1)
    assert cost == 0 and clip == 0
    assert len(ops) == 20


def test_extension_mode_target_exhausted():
    t = "ACGTTGCAACGGTCAT"
    q = t + "GGGGGGGG"  # target runs out; tail must be soft-clipped
    cost, ops, clip = _align_pair(q, t, mode=1)
    assert clip == 8
    assert cost == 0
    _check_ops(q[: len(q) - clip], t, ops, cost)


def test_minimizers_and_index(rng):
    seq = random_genome(2000, rng)
    codes = encode_seq(seq)
    p, h, s = minimizers(codes, 15, 10)
    assert p.size > 2000 / 10 / 2  # roughly 2/(w+1) density
    assert (np.diff(p) > 0).all()
    idx = MinimizerIndex.build({"c": codes}, k=15, w=10)
    qi, cid, pos, st = idx.lookup(h)
    # every minimizer of the sequence must find itself
    assert set(p.tolist()) <= set(pos.tolist())


def test_chain_anchors_monotonic():
    q = np.array([10, 50, 30, 100, 150])
    t = np.array([110, 150, 160, 200, 250])
    chains = chain_anchors(q, t)
    assert len(chains) == 1
    cq, ct = chains[0]
    assert (np.diff(cq) > 0).all() and (np.diff(ct) > 0).all()


def test_find_chains_fwd_rev(rng):
    genome = random_genome(5000, rng)
    idx = MinimizerIndex.build({"g": encode_seq(genome)})
    read = genome[1000:2500]
    chains = find_chains(idx, encode_seq(read))
    assert chains and chains[0].strand == 1
    t0 = int(chains[0].t_anchors[0])
    assert abs(t0 - 1000 - int(chains[0].q_anchors[0])) < 5
    rc = revcomp(read)
    chains_rc = find_chains(idx, encode_seq(rc))
    assert chains_rc and chains_rc[0].strand == 0


def test_map_reads_perfect(rng):
    genome = random_genome(8000, rng)
    reads = [genome[500:2500], revcomp(genome[3000:5000]), genome[6000:7900]]
    alns = map_reads({"ctg": genome}, reads)
    assert len(alns) == 3
    for i, a in enumerate(alns):
        assert a.contig == "ctg"
        assert a.nm == 0
        assert a.aligned_query_span() == len(reads[a.read_idx])
    a0 = [a for a in alns if a.read_idx == 0][0]
    assert (a0.t_start, a0.t_end) == (500, 2500)
    a1 = [a for a in alns if a.read_idx == 1][0]
    assert a1.strand == 0
    assert (a1.t_start, a1.t_end) == (3000, 5000)


def test_map_reads_with_errors(rng):
    haps = make_haplotypes(6000, 1, 0.001, rng)
    sim = simulate_reads(haps, coverage=4, read_len=1500, rng=rng, sub_rate=0.03, ins_rate=0.02, del_rate=0.02)
    alns = map_reads({"ctg": haps[0]}, sim.seqs)
    mapped = {a.read_idx for a in alns}
    assert len(mapped) >= 0.95 * len(sim.seqs)
    for a in alns:
        # CIGAR must replay the oriented read against the contig
        seq = sim.seqs[a.read_idx]
        oriented = seq if a.strand == 1 else revcomp(seq)
        q_span = a.aligned_query_span()
        t_span = a.aligned_target_span()
        assert t_span == a.t_end - a.t_start
        if a.strand == 1:
            qseg = oriented[a.q_start : a.q_start + q_span]
        else:
            qseg = oriented[len(seq) - a.q_end : len(seq) - a.q_end + q_span]
        tseg = haps[0][a.t_start : a.t_end]
        exp = expand_cigar(a.cigar_ops, a.cigar_lens)
        _check_ops(qseg, tseg, exp, a.nm)
        # error rate should be near the simulated 7%
        assert a.nm / max(1, len(exp)) < 0.15


def test_rescue_mapping_at_ultra_noise(rng):
    """15-mer anchors starve at 28% read error; the shorter-minimizer rescue
    pass must still map nearly everything."""
    truth = random_genome(2000, rng)
    sim = simulate_reads([truth], coverage=20, read_len=2000, rng=rng,
                         sub_rate=0.14, ins_rate=0.07, del_rate=0.07)
    alns = map_reads({"t": truth}, sim.seqs)
    assert len({a.read_idx for a in alns}) >= 0.9 * len(sim.seqs)
    no_rescue = map_reads({"t": truth}, sim.seqs, MapConfig(rescue=False))
    assert len({a.read_idx for a in no_rescue}) < 0.7 * len(sim.seqs)


def test_native_cpu_fused_aligner_bit_identical():
    """hs_banded_align_tb (the CPU-backend job runner) must equal the jnp
    scan + host readout + traceback pair element for element, across the
    random job matrix incl. extension modes and degenerate lengths."""
    import numpy as np

    from hairsplitter_jax import native as N
    from tests.test_traceback_rows import random_batch

    if N.get_lib() is None:
        import pytest

        pytest.skip("native library unavailable")
    for spec_, n, seed in [
        (BandSpec(chunk=48, band=32), 64, 0),
        (BandSpec(chunk=64, band=64), 48, 1),
        (BandSpec(chunk=256, band=128), 48, 2),
    ]:
        rng = np.random.default_rng(seed)
        q, qlens, t, tlens = random_batch(rng, n, spec_)
        modes = (np.arange(n) % 2).astype(np.int32)
        res = {k: np.asarray(v) for k, v in banded_align_batch(q, qlens, t, tlens, spec_).items()}
        cost, si, sb, clip = readout(res, qlens, tlens, modes, spec_)
        ops_ref = traceback_batch(res["bp"], q, t, si, sb, spec_)
        ops_nat, cost_n, clip_n = N.banded_align_tb(q, qlens, t, tlens, modes, spec_.band)
        np.testing.assert_array_equal(cost, cost_n)
        np.testing.assert_array_equal(clip, clip_n)
        for k in range(n):
            np.testing.assert_array_equal(np.asarray(ops_ref[k], np.int8), ops_nat[k])
