"""Benchmark: the production mapping device call + pipeline throughput, on
the GPU.

Prints the card's name and power limit (nvidia-smi), then ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "detail": {...}}

The headline is the cell rate of the production mapping device call - DP +
readout + row-lockstep traceback fused (ops/align_device.py:
align_traceback_rows_multi_packed, K=16 2048-row buckets in one call: the
plain-JAX banded DP compiled by XLA). detail also carries
  mapping_read_kbp_per_s   - end-to-end mapping wall throughput
  pipeline_read_kbp_per_s  - warm FULL-pipeline wall throughput on the
                             300 kb 3-strain 30x dataset
  quality                  - per-strain recovery and switch errors.

Timing: device-resident inputs, dependency-chained calls, each window ends
in `block_until_ready`. Without a GPU the script exits non-zero; any failing
block fails the run.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np


def _bench_batch(spec, N: int):
    """Device-resident operands: queries + 5%-mutated targets so the DP
    follows realistic paths."""
    import jax

    from hairsplitter_jax.ops.align import T_SENTINEL

    rng = np.random.default_rng(0)
    q = rng.integers(0, 4, (N, spec.chunk)).astype(np.int8)
    t = np.full((N, spec.t_width), T_SENTINEL, dtype=np.int8)
    t[:, : spec.chunk] = np.where(
        rng.random((N, spec.chunk)) < 0.05, rng.integers(0, 4, (N, spec.chunk)), q
    )
    ql = np.full(N, spec.chunk, np.int32)
    tl = np.full(N, spec.chunk, np.int32)
    modes = np.zeros(N, np.int32)
    return tuple(jax.device_put(a) for a in (q, ql, t, tl, modes))


def _time_chained(one, windows: int = 3, iters: int = 10) -> float:
    """Best-of-`windows` of `iters` dependency-chained calls; returns
    seconds per call."""
    import jax
    import jax.numpy as jnp

    jax.block_until_ready(one(jnp.zeros((), jnp.int32)))  # compile + settle
    best = float("inf")
    for _ in range(windows):
        acc = jnp.zeros((), jnp.int32)
        t0 = time.perf_counter()
        for _ in range(iters):
            acc = one(acc)
        jax.block_until_ready(acc)
        best = min(best, time.perf_counter() - t0)
    return best / iters


def fused_production_rate(spec) -> dict:
    """The headline: the production mapping device call for a large run —
    since round 5 that is the MULTI-BUCKET nibble-packed program
    (`align_traceback_rows_multi_packed`, K 2048-row buckets in one
    dispatch + one pull; `core/mapping.py:_run_jobs_device_tb_multi`).
    The single-bucket call (small remaps) rides along as a detail."""
    import jax
    import jax.numpy as jnp

    from hairsplitter_jax.ops.align_device import (
        align_traceback_rows_multi_packed,
        align_traceback_rows_packed,
        pack_nibbles_host,
    )

    N = 2048
    K = 16
    B, T = spec.chunk, spec.t_width
    q, ql, t, tl, modes = _bench_batch(spec, N)
    qp1 = pack_nibbles_host(np.asarray(q))
    tp1 = pack_nibbles_host(np.asarray(t))
    qp, tp = (
        jax.device_put(np.stack([a] * K)) for a in (qp1, tp1)
    )
    qlK, tlK, mK = (
        jax.device_put(np.stack([np.asarray(a)] * K)) for a in (ql, tl, modes)
    )
    qp1, tp1 = jax.device_put(qp1), jax.device_put(tp1)

    @jax.jit
    def one_multi(acc):
        f = align_traceback_rows_multi_packed(qp, qlK, tp, tlK, mK, spec, B, T)
        return acc + f[0, 0, 0].astype(jnp.int32) + f[-1, -1, -1].astype(jnp.int32)

    @jax.jit
    def one_single(acc):
        f = align_traceback_rows_packed(qp1, ql, tp1, tl, modes, spec, B, T)
        return acc + f[0, 0].astype(jnp.int32) + f[-1, -1].astype(jnp.int32)

    per_multi = _time_chained(one_multi, windows=3, iters=3)
    per_single = _time_chained(one_single)
    return {
        "cells_per_s": round(K * N * spec.chunk * spec.band / per_multi, 1),
        "fused_multi_ms_per_2048_bucket": round(per_multi * 1e3 / K, 2),
        "fused_multi_K": K,
        "fused_single_ms_per_2048": round(per_single * 1e3, 2),
        "fused_single_cells_per_s": round(N * spec.chunk * spec.band / per_single, 1),
    }


def raw_dp_rate(spec) -> dict:
    """The banded DP alone, without readout and traceback (detail), at
    N=16384."""
    import jax
    import jax.numpy as jnp

    from hairsplitter_jax.ops.align import banded_align_batch

    N = 16384
    q, ql, t, tl, _ = _bench_batch(spec, N)

    @jax.jit
    def one(acc):
        r = banded_align_batch(q, ql, t, tl, spec)
        return acc + r["row_at_q"][0, 0].astype(jnp.int32) + r["bp"][-1, -1, -1].astype(jnp.int32)

    per_call = _time_chained(one, windows=4)
    return {
        "raw_dp_cells_per_s": round(N * spec.chunk * spec.band / per_call, 1),
        "raw_dp_batch": N,
    }


def mapping_kbps() -> dict:
    """End-to-end mapping throughput (read kbp mapped per second, wall
    clock, host orchestration included). Mirrors the BASELINE.md dataset:
    100 kb contig at 36x with 10%-error 8 kb reads."""
    from hairsplitter_jax.core.mapping import MapConfig, map_reads
    from hairsplitter_jax.utils.sim import random_genome, simulate_reads

    rng = np.random.default_rng(1)
    size, cov, rlen = 100_000, 36, 8000
    genome = random_genome(size, rng)
    sim = simulate_reads(
        [genome], coverage=cov, read_len=rlen, rng=rng,
        sub_rate=0.05, ins_rate=0.025, del_rate=0.025,
    )
    total_bp = sum(len(s) for s in sim.seqs)
    cfg = MapConfig()
    map_reads({"c": genome}, sim.seqs, cfg)  # compile + settle
    best = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        alns = map_reads({"c": genome}, sim.seqs, cfg)
        best = min(best, time.perf_counter() - t0)
    return {
        "mapping_read_kbp_per_s": round(total_bp / 1e3 / best, 1),
        "mapping_dataset": f"{size//1000}kb x {cov}x, {rlen//1000}kb reads, 10% err",
        "mapping_alignments": len(alns),
    }


def pipeline_kbps() -> dict:
    """Warm full-pipeline wall throughput: the cold run pays the compiles,
    the warm run reuses them. 300 kb x 3 strains x 30x."""
    from hairsplitter_jax.io.fasta import write_fasta
    from hairsplitter_jax.pipeline.orchestrate import PipelineConfig, run_pipeline
    from hairsplitter_jax.utils import sim as hsim

    length, strains, cov = 300_000, 3, 30
    rng = np.random.default_rng(7)
    haps = hsim.make_haplotypes(length, strains, 0.01, rng)
    reads = hsim.simulate_reads(
        haps, coverage=cov / strains, read_len=8000, rng=rng,
        sub_rate=0.06, ins_rate=0.02, del_rate=0.02,
    )
    total_kbp = sum(len(s) for s in reads.seqs) / 1e3
    root = tempfile.mkdtemp(prefix="hs_bench_pipe_")
    try:
        asm_path = os.path.join(root, "assembly.fasta")
        reads_path = os.path.join(root, "reads.fasta")
        write_fasta(asm_path, {"asm": haps[0]})
        hsim.write_sim_fasta(reads_path, reads)
        import contextlib

        with open(os.devnull, "w") as null, contextlib.redirect_stdout(null):
            # the pipeline logger prints progress lines; bench.py's contract
            # is ONE JSON line on stdout
            run_pipeline(asm_path, reads_path, os.path.join(root, "out0"), PipelineConfig())
            t0 = time.perf_counter()
            run_pipeline(asm_path, reads_path, os.path.join(root, "out1"), PipelineConfig())
            dt = time.perf_counter() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {
        "pipeline_read_kbp_per_s": round(total_kbp / dt, 1),
        "pipeline_warm_wall_s": round(dt, 1),
        "pipeline_dataset": f"{length//1000}kb x {strains} strains, {cov}x, 10% err",
    }


def quality_block() -> dict:
    """Fidelity alongside speed: the hard-mode 3-strain mix
    — abundances 1.0/0.3/0.05 (the rare strain at the advertised
    `--rarest-strain-abundance` floor), homopolymer-biased indels, 2%
    chimeric reads — scored for per-strain k-mer recovery and switch
    errors. Mirrors tests/test_stress_quality.py."""
    import contextlib

    from hairsplitter_jax.io.fasta import write_fasta
    from hairsplitter_jax.io.gfa import parse_gfa
    from hairsplitter_jax.pipeline.orchestrate import PipelineConfig, run_pipeline
    from hairsplitter_jax.utils import sim as hsim
    from hairsplitter_jax.utils.evaluate import evaluate_phasing

    length, cov = 40_000, 280
    rng = np.random.default_rng(3)
    haps = hsim.make_haplotypes(length, 3, 0.01, rng)
    reads = hsim.simulate_reads(
        haps, coverage=cov, read_len=8000, rng=rng,
        sub_rate=0.06, ins_rate=0.02, del_rate=0.02,
        abundances=[1.0, 0.3, 0.05], homopolymer_bias=1.0, chimera_rate=0.02,
        uniform_edges=True,
    )
    root = tempfile.mkdtemp(prefix="hs_bench_q_")
    try:
        asm = os.path.join(root, "asm.fa")
        rd = os.path.join(root, "reads.fa")
        write_fasta(asm, {"asm": haps[0]})
        hsim.write_sim_fasta(rd, reads)
        t0 = time.perf_counter()
        with open(os.devnull, "w") as null, contextlib.redirect_stdout(null):
            final = run_pipeline(asm, rd, os.path.join(root, "out"), PipelineConfig())
        dt = time.perf_counter() - t0
        ev = evaluate_phasing(parse_gfa(final).segments, haps)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {
        "quality": {
            "dataset": f"{length//1000}kb x 3 strains @ 1.0/0.3/0.05, {cov}x base, "
            "hp-biased indels, 2% chimeras",
            "strain_recovery": [round(r, 4) for r in ev.haplotype_recovery],
            "rare_strain_recovery": round(ev.haplotype_recovery[2], 4),
            "switch_errors": ev.total_switch_errors,
            "wall_s": round(dt, 1),
        }
    }


def main():
    import subprocess

    import jax

    from hairsplitter_jax.ops.align import BandSpec
    from hairsplitter_jax.runtime import device_summary, init_compile_cache

    init_compile_cache()
    dev = device_summary()
    if dev["platform"] != "gpu":
        sys.exit(f"bench.py measures the GPU; JAX found {dev}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip()
    print(f"card: {card}", flush=True)
    spec = BandSpec(chunk=256, band=128)

    fused = fused_production_rate(spec)
    cells_per_s = fused.pop("cells_per_s")
    detail = {
        "batch": 2048,
        "chunk": spec.chunk,
        "band": spec.band,
        "timing": "device-resident inputs, dependency-chained calls, block_until_ready",
        "headline": "production mapping device call for large runs: K=16 2048-row "
        "buckets of fused DP + readout + traceback in ONE call, nibble-packed "
        "uploads - the call core/mapping.py:_run_jobs_device_tb_multi makes",
        "device": dev,
        "card": card,
        **fused,
        **raw_dp_rate(spec),
        **mapping_kbps(),
        **pipeline_kbps(),
        **quality_block(),
    }
    print(
        json.dumps(
            {
                "metric": "banded_align_DP_cells_per_s",
                "value": cells_per_s,
                "unit": "cells/s",
                "detail": detail,
            }
        )
    )


if __name__ == "__main__":
    main()
