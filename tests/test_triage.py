"""Polishing triage ladder (reference tools.cpp:914-1166): a structurally
wrong backbone inside one group must still yield a correct output contig."""

import numpy as np

from hairsplitter_jax.constants import encode_seq
from hairsplitter_jax.core.mapping import map_reads
from hairsplitter_jax.io.gfa import AssemblyGraph
from hairsplitter_jax.ops.triage import (
    BACKBONE_BIG_INDELS,
    BACKBONE_BREAKPOINTS,
    BACKBONE_GOOD,
    alternative_backbone,
    check_backbone,
)
from hairsplitter_jax.pipeline.new_contigs import create_new_contigs
from hairsplitter_jax.pipeline.pileup import alignment_cells_full, orient_read
from hairsplitter_jax.pipeline.separate_reads import ContigGroups, WindowGroups
from hairsplitter_jax.utils.sim import random_genome, simulate_reads


def _cells_of(alns, seqs):
    cells, inss = [], []
    for a in alns:
        oriented = orient_read(encode_seq(seqs[a.read_idx]), a.strand)
        tpos, tri, it, ic = alignment_cells_full(a, oriented)
        cells.append((tpos, (np.asarray(tri, np.int16) // 25).astype(np.int8)))
        inss.append((it, ic))
    return cells, inss


def _overlap(a, b, k=21):
    ka = {a[i : i + k] for i in range(len(a) - k + 1)}
    kb = {b[i : i + k] for i in range(len(b) - k + 1)}
    return len(ka & kb) / max(1, len(ka))


def test_check_backbone_good(rng):
    truth = random_genome(3000, rng)
    sim = simulate_reads([truth], coverage=10, read_len=1500, rng=rng, sub_rate=0.03)
    alns = map_reads({"b": truth}, sim.seqs)
    code = check_backbone(alns, [len(sim.seqs[a.read_idx]) for a in alns], 0, 2999)
    assert code == BACKBONE_GOOD


def test_check_backbone_big_deletion(rng):
    # reads carry a 60bp deletion vs the backbone -> recurrent big D runs
    backbone = random_genome(3000, rng)
    truth = backbone[:1500] + backbone[1560:]
    sim = simulate_reads([truth], coverage=12, read_len=1400, rng=rng)
    alns = map_reads({"b": backbone}, sim.seqs)
    code = check_backbone(alns, [len(sim.seqs[a.read_idx]) for a in alns], 0, 2999)
    assert code == BACKBONE_BIG_INDELS


def test_check_backbone_too_few_reads(rng):
    assert check_backbone([], [], 0, 100) == BACKBONE_BREAKPOINTS


def test_alternative_backbone_carries_deletion(rng):
    backbone = random_genome(2000, rng)
    truth = backbone[:1000] + backbone[1080:]  # 80bp deletion
    sim = simulate_reads([truth], coverage=15, read_len=1000, rng=rng)
    alns = map_reads({"b": backbone}, sim.seqs)
    cells, inss = _cells_of(alns, sim.seqs)
    patched = alternative_backbone(encode_seq(backbone), 0, cells, inss)
    # the patched backbone is ~80bp shorter and matches the truth; uncovered
    # edge positions are dropped (reference behavior), so allow slack — the
    # downstream polish converges the remainder
    assert abs(len(patched) - len(truth)) < 80, (len(patched), len(truth))
    assert _overlap(patched, truth) > 0.85


def test_structurally_wrong_backbone_still_polishes_correctly(rng):
    # the interval backbone misses a 300bp segment the group's reads all
    # carry — wider than the DP band, so plain pileup voting cannot recover
    # it; the triage ladder must rebuild the backbone first
    # (reference done-criterion: tools.cpp:914-1166)
    backbone = random_genome(4000, rng)
    insert = random_genome(300, rng)
    truth = backbone[:2000] + insert + backbone[2000:]
    sim = simulate_reads([truth], coverage=15, read_len=2000, rng=rng, sub_rate=0.01)
    alns = map_reads({"ctg": backbone}, sim.seqs)
    asm = AssemblyGraph()
    asm.add_segment("ctg", backbone, depth=15)
    # two groups sharing the same (wrong) backbone forces the polish path
    labels = np.array([r % 2 for r in range(len(alns))], dtype=np.int64)
    groups = ContigGroups("ctg", len(backbone), 15.0, [WindowGroups(0, len(backbone) - 1, labels)])
    reads = {i: s for i, s in enumerate(sim.seqs)}
    res = create_new_contigs(asm, {"ctg": (alns, groups)}, reads)
    outs = [s for n, s in res.graph.segments.items() if n.startswith("ctg_")]
    assert outs
    best = max(outs, key=lambda s: _overlap(s, truth))
    assert _overlap(best, truth) > 0.9, _overlap(best, truth)
    assert abs(len(best) - len(truth)) < 100, (len(best), len(truth))
