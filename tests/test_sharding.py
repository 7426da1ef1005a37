"""Multi-device mesh tests on the 8-device virtual CPU mesh (SURVEY §5:
contig data parallelism x position/SNP sequence parallelism).

The sharded step is the PRODUCTION phasing code (`ops/phase.py`) — the same
`phase_window_core` the pipeline runs per window — and sharded == unsharded
is asserted bit-for-bit (all cross-shard reductions are integer-exact)."""

import jax
import numpy as np

from hairsplitter_jax.ops.phase import phase_contigs_batch, read_graph_device
from hairsplitter_jax.parallel.mesh import (
    make_mesh,
    make_phase_example,
    phase_shard_step,
)


def test_make_mesh_shapes():
    mesh = make_mesh(8)
    assert mesh.devices.size == 8
    assert mesh.axis_names == ("ctg", "pos")
    mesh4 = make_mesh(4)
    assert mesh4.devices.size == 4


def test_phase_step_single_device_separates():
    example = make_phase_example(C=2, Rr=32, Pp=512, S=32, K=8)
    err, adj, labels = jax.jit(phase_contigs_batch)(*example)
    assert 0.0 < float(err) < 1.0
    assert adj.shape == (2, 32, 32)
    labels = np.asarray(labels)
    # the example is a clean 2-haplotype split: every seeded CW run must
    # recover it exactly (reads alternate haplotypes by index parity)
    truth = np.arange(32) % 2
    for c in range(2):
        for k in range(labels.shape[1]):
            lab = labels[c, k]
            assert len(set(lab.tolist())) >= 2
            for g in set(lab.tolist()):
                assert len(set(truth[lab == g].tolist())) == 1, "mixed cluster"


def test_read_graph_device_matches_host():
    from hairsplitter_jax.pipeline.separate_reads import build_read_graph

    rng = np.random.default_rng(0)
    n = 48
    group = np.arange(n) % 3
    same = group[:, None] == group[None, :]
    sim = np.where(same, rng.integers(20, 40, (n, n)), rng.integers(0, 12, (n, n))).astype(np.int32)
    diff = np.where(same, rng.integers(0, 3, (n, n)), rng.integers(8, 25, (n, n))).astype(np.int32)
    sim = np.maximum(sim, sim.T)
    diff = np.maximum(diff, diff.T)
    np.fill_diagonal(sim, 0)
    np.fill_diagonal(diff, 0)
    mask = np.ones(n, bool)
    mask[::7] = False
    for err in (0.02, 0.15):
        host = build_read_graph(mask, sim, diff, err)
        dev = np.asarray(read_graph_device(sim, diff, mask, np.float32(err)))
        np.testing.assert_array_equal(dev, (host > 0).astype(np.int8))


def test_phase_shard_step_matches_unsharded():
    mesh = make_mesh(8)
    ctg, pos = mesh.devices.shape
    example = make_phase_example(C=2 * ctg, Rr=32, Pp=128 * pos, S=8 * pos, K=4)
    fn, args = phase_shard_step(mesh, example)
    err_s, adj_s, labels_s = fn(*args)
    # same computation, unsharded — must be bit-identical (integer reductions)
    err_u, adj_u, labels_u = jax.jit(phase_contigs_batch)(*example)
    assert float(err_s) == float(err_u)
    np.testing.assert_array_equal(np.asarray(adj_s), np.asarray(adj_u))
    np.testing.assert_array_equal(np.asarray(labels_s), np.asarray(labels_u))
    assert labels_s.sharding.spec[0] == "ctg"


def test_pipeline_window_uses_mesh_code():
    """The pipeline's device window step is the function the mesh shards."""
    from hairsplitter_jax.ops.phase import phase_windows_jit
    from hairsplitter_jax.pipeline import separate_reads as sr

    assert sr.SeparateConfig(use_device_cw=True).device_cw_resolved()
    # source-level wiring: the device branch calls ops.phase.phase_windows_jit
    # (the vmapped batch over phase_window_core, which the mesh also shards)
    import inspect

    src = inspect.getsource(sr.separate_reads_for_contig)
    assert "_phase_windows_compact" in src and "_phase_windows_full" in src
    assert "phase_windows_sub_jit" in inspect.getsource(sr._phase_windows_compact)
    assert "phase_windows_jit" in inspect.getsource(sr._phase_windows_full)
    assert phase_windows_jit is not None


def test_graft_entry_points():
    import sys

    sys.path.insert(0, "/root/repo")
    import __graft_entry__ as ge

    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    assert len(out) == 3
    ge.dryrun_multichip(8)


def test_map_shard_step_bit_identical():
    """The fused mapping call (DP + readout + traceback) sharded over every
    mesh device equals the single-device call bit for bit — mapping is pure
    data parallelism over chunk rows (no collectives)."""
    import numpy as np

    from hairsplitter_jax.ops.align import BandSpec
    from hairsplitter_jax.ops.align_device import align_traceback_rows
    from hairsplitter_jax.parallel.mesh import make_mesh, map_shard_step

    mesh = make_mesh(8)
    fn, args = map_shard_step(mesh)
    out = np.asarray(fn(*args))
    ref = np.asarray(
        align_traceback_rows(*(np.asarray(a) for a in args), BandSpec(chunk=64, band=32))
    )
    np.testing.assert_array_equal(out, ref)


def test_phase_shard_production_shapes_bit_identical():
    """Round-5 #8: sharded == host at PRODUCTION-like shapes (R=512 reads,
    S=256 SNP columns, 2048-position pileup blocks), not just toy sizes —
    realistic padding/bucketing must survive the mesh."""
    mesh = make_mesh(8)
    ctg, pos = mesh.devices.shape
    example = make_phase_example(C=2 * ctg, Rr=512, Pp=max(256 * pos, 2048),
                                 S=max(64 * pos, 256), K=4)
    fn, args = phase_shard_step(mesh, example)
    err_s, adj_s, labels_s = fn(*args)
    err_u, adj_u, labels_u = jax.jit(phase_contigs_batch)(*example)
    assert float(err_s) == float(err_u)
    np.testing.assert_array_equal(np.asarray(adj_s), np.asarray(adj_u))
    np.testing.assert_array_equal(np.asarray(labels_s), np.asarray(labels_u))


def test_column_stats_shard_matches_host():
    """Stage-3's window column-stats kernel under the mesh: bit-identical
    to the host numpy twin at production shapes."""
    from hairsplitter_jax.ops.variants import column_stats_host
    from hairsplitter_jax.parallel.mesh import column_stats_shard_step

    mesh = make_mesh(8)
    ctg, pos = mesh.devices.shape
    example = make_phase_example(C=2 * ctg, Rr=512, Pp=max(256 * pos, 2048),
                                 S=64, K=2)
    pileup = example[0]
    fn, args = column_stats_shard_step(mesh, pileup)
    tc, tn, cov = fn(*args)
    tc, tn, cov = np.asarray(tc), np.asarray(tn), np.asarray(cov)
    for c in range(pileup.shape[0]):
        htc, htn, hcov = column_stats_host(pileup[c])
        np.testing.assert_array_equal(tc[c], htc)
        np.testing.assert_array_equal(tn[c], htn)
        np.testing.assert_array_equal(cov[c], hcov)
