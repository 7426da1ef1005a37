"""Device-mesh sharding of the PRODUCTION phasing step (SPMD contigs x SNPs).

The reference is single-node OpenMP: a `parallel for` over contigs with one
critical-section reduction for the global error rate
(`src/call_variants.cpp:1276-1371`). Here the same structure becomes a 2-D
`jax.sharding.Mesh` over `ops.phase.phase_contigs_batch` — the exact device
code the pipeline runs per window (`pipeline/separate_reads.py` routes its
device branch through `phase_window_core`):

  axis 'ctg'  — data parallelism over contig windows, the OpenMP-loop axis;
  axis 'pos'  — sequence parallelism over pileup positions / SNP columns
                (the reference's 300 kb chunking + 2000 bp windowing axis).

XLA inserts the collectives: an all-reduce for the global error rate (int
sums — exact) and for the sims/diffs contraction over the sharded SNP axis
(0/1 indicator products — exact in f32), so sharded == unsharded bit for bit
(tests/test_sharding.py). The mesh follows the algorithm alone: the four
GPUs of one host are joined all to all by NVLink, so no axis placement is
cheaper than another.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..constants import N_TRIMERS, TRIMER_ABSENT
from ..ops.phase import phase_contigs_batch


def make_mesh(n_devices: int | None = None) -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    n = len(devs)
    # factor n into (ctg, pos) as square as possible
    ctg = 1
    for f in range(int(np.sqrt(n)), 0, -1):
        if n % f == 0:
            ctg = f
            break
    return Mesh(np.asarray(devs).reshape(ctg, n // ctg), ("ctg", "pos"))


def make_phase_example(C=4, Rr=64, Pp=512, S=64, K=8, seed=0):
    """A nontrivial two-haplotype example: reads split into two groups whose
    allele indicators disagree at the S SNP columns (with noise), so the
    production knee-rule graph and CW actually separate them."""
    rng = np.random.default_rng(seed)
    group = (np.arange(Rr) % 2).astype(np.int8)  # alternating haplotypes
    # pileup: central base differs from the contig where a read carries the
    # alt; ~20% of cells uncovered
    contig_codes = rng.integers(0, 4, (C, Pp)).astype(np.int8)
    pileup = np.broadcast_to(contig_codes[:, None, :] * 25, (C, Rr, Pp)).astype(np.int8).copy()
    err_cells = rng.random((C, Rr, Pp)) < 0.03
    pileup[err_cells] = rng.integers(0, N_TRIMERS, int(err_cells.sum())).astype(np.int8)
    pileup[rng.random((C, Rr, Pp)) < 0.2] = TRIMER_ABSENT
    # allele indicators at SNPs: group 1 carries the second allele, with 5%
    # noise; both groups always covered at ~85% of SNPs
    covered = rng.random((C, Rr, S)) < 0.85
    carries_alt = (group[None, :, None] == 1) ^ (rng.random((C, Rr, S)) < 0.05)
    A = (covered & carries_alt).astype(np.float32)
    R = (covered & ~carries_alt).astype(np.float32)
    # seeds: per (contig, seed-SNP) the reference labels each read with the
    # first read sharing its allele (`src/separate_reads.cpp:1674-1693`)
    inits = np.zeros((C, K, Rr), dtype=np.int32)
    for c in range(C):
        for k in range(K):
            col = rng.integers(0, S)
            alt = A[c, :, col] > 0
            first_alt = int(np.argmax(alt)) if alt.any() else 0
            first_ref = int(np.argmax(~alt)) if (~alt).any() else 0
            inits[c, k] = np.where(alt, first_alt, first_ref)
    mask = np.ones((C, Rr), dtype=bool)
    return pileup, contig_codes, A, R, mask, inits


def phase_shard_step(mesh: Mesh, example=None):
    """jit the production phase step over the mesh with real shardings;
    returns (compiled fn, device-placed example args)."""
    if example is None:
        example = make_phase_example()
    s_pileup = NamedSharding(mesh, P("ctg", None, "pos"))
    s_contig = NamedSharding(mesh, P("ctg", "pos"))
    s_AR = NamedSharding(mesh, P("ctg", None, "pos"))  # SNP axis over 'pos'
    s_rows = NamedSharding(mesh, P("ctg", None))
    s_inits = NamedSharding(mesh, P("ctg", None, None))
    shardings = (s_pileup, s_contig, s_AR, s_AR, s_rows, s_inits)
    args = tuple(jax.device_put(a, s) for a, s in zip(example, shardings))
    fn = jax.jit(
        phase_contigs_batch,
        in_shardings=shardings,
        out_shardings=(
            NamedSharding(mesh, P()),
            NamedSharding(mesh, P("ctg", None, None)),
            NamedSharding(mesh, P("ctg", None, None)),
        ),
    )
    return fn, args


def column_stats_shard_step(mesh: Mesh, pileup: np.ndarray):
    """Stage-3's window column-stats kernel (`ops/variants.column_stats`:
    per-position top-3 trimer counts + coverage) under the mesh: contigs
    over 'ctg', pileup positions over 'pos'. Every statistic is
    position-local, so sharding inserts no collectives and sharded ==
    unsharded holds bit for bit. Returns (jitted fn, device-placed args)."""
    from ..ops.variants import column_stats

    batched = jax.vmap(column_stats)
    s_pileup = NamedSharding(mesh, P("ctg", None, "pos"))
    args = (jax.device_put(pileup, s_pileup),)
    fn = jax.jit(
        batched,
        in_shardings=(s_pileup,),
        out_shardings=(
            NamedSharding(mesh, P("ctg", "pos", None)),
            NamedSharding(mesh, P("ctg", "pos", None)),
            NamedSharding(mesh, P("ctg", "pos")),
        ),
    )
    return fn, args


def make_map_example(n: int, spec, seed: int = 0, err: float = 0.05):
    """A batch of realistic DP jobs: queries + mutated targets with varied
    lengths (exercises the readout masks and traceback)."""
    from ..ops.align import Q_SENTINEL, T_SENTINEL

    rng = np.random.default_rng(seed)
    B, T = spec.chunk, spec.t_width
    q = np.full((n, B), Q_SENTINEL, np.int8)
    t = np.full((n, T), T_SENTINEL, np.int8)
    qlens = rng.integers(B // 2, B + 1, n).astype(np.int32)
    tlens = np.zeros(n, np.int32)
    for i in range(n):
        base = rng.integers(0, 4, qlens[i]).astype(np.int8)
        q[i, : qlens[i]] = base
        mut = np.where(rng.random(qlens[i]) < err, rng.integers(0, 4, qlens[i]), base)
        tl = min(T, qlens[i] + int(rng.integers(-4, 5)))
        t[i, :tl] = np.resize(mut, tl)
        tlens[i] = tl
    modes = (np.arange(n) % 2).astype(np.int32)
    return q, qlens, t, tlens, modes


def map_shard_step(mesh: Mesh, n_per_device: int = 8, spec=None):
    """The OTHER production device path under the mesh: the fused mapping
    call (DP + readout + row-lockstep traceback, `ops/align_device.py:
    align_traceback_rows` — the exact call `core/mapping.py` dispatches per
    bucket) with the batch axis sharded across EVERY mesh device via
    `shard_map`. Chunk alignments are independent, so mapping is pure data
    parallelism (no collectives): each device DPs its own rows and ships
    its own token slice home.

    Returns (jitted fn, device-placed sharded args)."""
    from ..ops.align import BandSpec
    from ..ops.align_device import align_traceback_rows

    spec = spec or BandSpec(chunk=64, band=32)
    n_dev = int(mesh.devices.size)
    example = make_map_example(n_per_device * n_dev, spec)
    batch_axes = P(("ctg", "pos"))  # flatten both mesh axes over the batch
    sharding = NamedSharding(mesh, batch_axes)
    args = tuple(jax.device_put(a, sharding) for a in example)
    fn = jax.jit(
        jax.shard_map(
            lambda q, ql, t, tl, m: align_traceback_rows(q, ql, t, tl, m, spec),
            mesh=mesh,
            in_specs=(batch_axes,) * 5,
            out_specs=batch_axes,
            # the DP scan mixes device-varying carries with replicated
            # constants (iotas, INF rows); there are no collectives to get
            # wrong in a purely-data-parallel body
            check_vma=False,
        )
    )
    return fn, args
