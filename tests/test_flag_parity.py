"""Round-4 flag-parity fixes vs the reference CLI semantics
(VERDICT r3 item 4): -s/--dont_merge, --rarest-strain-abundance default,
amplicon coverage-sorted export, single-read-group triage routing."""

import numpy as np
import pytest

from hairsplitter_jax.graphunzip import main as gz_main
from hairsplitter_jax.io.gfa import parse_gfa
from hairsplitter_jax.utils.sim import random_genome


def test_rarest_strain_abundance_default_is_reference():
    """Reference default 0.01 (`hairsplitter.py:45`) -> per-column coverage
    cap 50/0.01 = 5000 (`separate_reads.cpp:1420-1426`)."""
    from hairsplitter_jax.cli import parse_args
    from hairsplitter_jax.pipeline.orchestrate import PipelineConfig

    assert PipelineConfig().rarest_strain_abundance == 0.01
    args = parse_args(["-i", "a.gfa", "-f", "r.fa", "-o", "out"])
    assert args.rarest_strain_abundance == 0.01


@pytest.fixture
def collapsed(tmp_path, rng):
    seqs = {n: random_genome(800, rng) for n in ("A1", "A2", "C1", "C2")}
    seqs["X"] = random_genome(1200, rng)
    gfa = tmp_path / "in.gfa"
    with open(gfa, "w") as f:
        for n, s in seqs.items():
            depth = {"X": 40}.get(n, 20)
            f.write(f"S\t{n}\t{s}\tDP:f:{depth}\n")
        for a in ("A1", "A2"):
            f.write(f"L\t{a}\t+\tX\t+\t0M\n")
        for c in ("C1", "C2"):
            f.write(f"L\tX\t+\t{c}\t+\t0M\n")
    gaf = tmp_path / "aln.gaf"
    with open(gaf, "w") as f:
        for k in range(3):
            for r, p in (("r1", ">A1>X>C1"), ("r2", ">A2>X>C2")):
                f.write(f"{r}_{k}\t1000\t0\t1000\t+\t{p}\t3000\t0\t3000\t950\t1000\t60\tid:f:0.95\n")
    return gfa, gaf, seqs


def test_dont_merge_duplicates_without_merging(collapsed, tmp_path):
    """`-s` passes --dont_merge to GraphUnzip (`hairsplitter.py:806-816`):
    the collapsed contig is still duplicated per haplotype, but unbranched
    chains are NOT merged into supercontigs."""
    gfa, gaf, seqs = collapsed
    out = tmp_path / "out.gfa"
    sup = tmp_path / "sup.txt"
    rc = gz_main(
        ["unzip", "-g", str(gfa), "-l", str(gaf), "-o", str(out), "-e",
         "--dont_merge", "--supercontigs", str(sup)]
    )
    assert rc == 0
    g = parse_gfa(str(out))
    # X duplicated into two copies; A1/A2/C1/C2 still separate -> 6 contigs
    assert len(g.segments) == 6
    copies = [n for n in g.segments if n.startswith("X-copy")]
    assert len(copies) == 2
    assert all(g.segments[c] == seqs["X"] for c in copies)
    # nothing merged: every original flank survives under its own name
    for n in ("A1", "A2", "C1", "C2"):
        assert g.segments[n] == seqs[n]


def test_sort_coverage_export_order(collapsed, tmp_path):
    """-x sorts exported contigs by coverage (amplicon mode,
    `graphunzip.py:468-472`, `input_output.py:379-383`); default is by
    length, longest first."""
    gfa, gaf, seqs = collapsed
    out = tmp_path / "outx.gfa"
    rc = gz_main(
        ["unzip", "-g", str(gfa), "-l", str(gaf), "-o", str(out), "-e",
         "--dont_merge", "-x", "--supercontigs", str(tmp_path / "s.txt")]
    )
    assert rc == 0
    g = parse_gfa(str(out))
    depths = [g.depths.get(n, 0.0) for n in g.segments]
    assert depths == sorted(depths, reverse=True)
    # default: sorted by length descending
    out2 = tmp_path / "outlen.gfa"
    gz_main(
        ["unzip", "-g", str(gfa), "-l", str(gaf), "-o", str(out2), "-e",
         "--dont_merge", "--supercontigs", str(tmp_path / "s2.txt")]
    )
    g2 = parse_gfa(str(out2))
    lens = [len(s) for s in g2.segments.values()]
    assert lens == sorted(lens, reverse=True)


def test_single_read_group_routes_to_triage(monkeypatch):
    """Groups with <2 reads must reach the triage ladder (reference
    `check_alignment` returns 2 when nb_reads < 2, tools.cpp:1045-1047) —
    previously they bypassed it and a one-read backbone shipped as-is."""
    from hairsplitter_jax.core.mapping import MapConfig, map_reads
    from hairsplitter_jax.io.gfa import AssemblyGraph
    from hairsplitter_jax.pipeline import new_contigs as nc
    from hairsplitter_jax.pipeline.separate_reads import ContigGroups, WindowGroups
    from hairsplitter_jax.utils.sim import random_genome

    rng = np.random.default_rng(7)
    contig = random_genome(3000, rng)
    reads = [contig[100:2900], contig[120:2880], contig[80:2850]]
    asm = AssemblyGraph()
    asm.add_segment("c", contig, depth=3.0)
    alns = sorted(map_reads({"c": contig}, reads, MapConfig()), key=lambda a: a.read_idx)
    assert len(alns) == 3
    # separated window: reads 0+1 in group 0, read 2 alone in group 1
    labels = np.array([0, 0, 1], dtype=np.int64)
    groups = ContigGroups(
        "c", len(contig), 3.0, windows=[WindowGroups(0, len(contig) - 1, labels)]
    )

    calls = []
    real_check = nc.check_backbone

    def spy(alns_, lens_, s, e):
        calls.append(len(alns_))
        return real_check(alns_, lens_, s, e)

    monkeypatch.setattr(nc, "check_backbone", spy)
    zr = nc.create_new_contigs(asm, {"c": (alns, groups)}, dict(enumerate(reads)))
    # BOTH groups went through the triage check, including the 1-read group
    assert sorted(calls) == [1, 2]
    assert len(zr.graph.segments) == 2


def test_minimap2_params_translate_to_mapper():
    """--minimap2-params '-k19 -w19' tunes the built-in mapper; external
    tool path flags are accepted no-ops (reference hairsplitter.py:46-50)."""
    from hairsplitter_jax.cli import apply_minimap2_params, parse_args
    from hairsplitter_jax.pipeline.orchestrate import PipelineConfig

    args = parse_args([
        "-i", "a.gfa", "-f", "r.fa", "-o", "out",
        "--minimap2-params", "-k19 -w 19 --secondary=no",
        "--path_to_medaka", "/usr/bin/medaka",
    ])
    assert args.minimap2_params == "-k19 -w 19 --secondary=no"
    cfg, ignored = apply_minimap2_params(PipelineConfig(), args.minimap2_params)
    assert cfg.map.k == 19 and cfg.map.w == 19
    assert ignored == ["--secondary=no"]
