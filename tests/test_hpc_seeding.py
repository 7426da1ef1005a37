"""Homopolymer-compressed seeding (minimap2 -H / map-pb; round-5 #6).

The reference's pacbio preset is `minimap2 -x map-pb`, which seeds in HPC
space (`hairsplitter.py:629`); CLR-profile errors are hp-indel-dominated,
so raw k19 minimizers starve of anchors.
"""

import numpy as np

from hairsplitter_jax.core.mapping import MapConfig, map_reads
from hairsplitter_jax.core.seeding import MinimizerIndex, hpc_compress, minimizers
from hairsplitter_jax.constants import encode_seq
from hairsplitter_jax.utils.sim import random_genome, simulate_reads


def test_hpc_compress():
    codes = encode_seq("AAACCGTTTTA")
    comp, orig = hpc_compress(codes)
    np.testing.assert_array_equal(comp, encode_seq("ACGTA"))
    np.testing.assert_array_equal(orig, [0, 3, 5, 6, 10])
    c2, o2 = hpc_compress(encode_seq(""))
    assert c2.size == 0 and o2.size == 0


def test_hpc_minimizers_positions_in_original_coords():
    rng = np.random.default_rng(0)
    g = random_genome(5000, rng)
    codes = encode_seq(g)
    p, h, s = minimizers(codes, 15, 10, hpc=True)
    assert p.size > 0
    assert int(p.max()) < len(g)
    # hashes equal plain minimizers over the compressed sequence
    comp, orig = hpc_compress(codes)
    p2, h2, s2 = minimizers(comp, 15, 10)
    np.testing.assert_array_equal(h, h2)
    np.testing.assert_array_equal(p, orig[p2])


def test_hpc_recall_on_clr_noise():
    """HPC seeding must beat raw k19 on hp-biased ~19% error reads (no
    rescue pass so the seeding itself is measured)."""
    rng = np.random.default_rng(0)
    genome = random_genome(30_000, rng)
    sim = simulate_reads(
        [genome], coverage=8, read_len=6000, rng=rng,
        sub_rate=0.06, ins_rate=0.07, del_rate=0.06, homopolymer_bias=1.5,
    )
    raw = map_reads({"c": genome}, sim.seqs, MapConfig(k=19, w=10, rescue=False))
    hpc = map_reads({"c": genome}, sim.seqs, MapConfig(k=19, w=10, hpc=True, rescue=False))
    bp_raw = sum(a.q_end - a.q_start for a in raw)
    bp_hpc = sum(a.q_end - a.q_start for a in hpc)
    mapped_hpc = len({a.read_idx for a in hpc})
    assert mapped_hpc == len(sim.seqs), "HPC must map every CLR-noise read"
    assert bp_hpc > bp_raw, f"HPC aligned bp {bp_hpc} must beat raw {bp_raw}"


def test_pacbio_preset_enables_hpc():
    from hairsplitter_jax.pipeline.orchestrate import PipelineConfig, apply_tech_preset

    cfg = apply_tech_preset(PipelineConfig(technology="pacbio"))
    assert cfg.map.hpc is True and cfg.map.k == 19
    ont = apply_tech_preset(PipelineConfig(technology="ont"))
    assert ont.map.hpc is False


def test_hpc_index_flag_propagates():
    rng = np.random.default_rng(1)
    g = {"c": encode_seq(random_genome(3000, rng))}
    idx = MinimizerIndex.build(g, k=15, w=10, hpc=True)
    assert idx.hpc is True
