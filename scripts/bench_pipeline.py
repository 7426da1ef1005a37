"""Warm full-pipeline profiling on the current backend.

Runs the end-to-end pipeline twice in one process on a simulated
multi-strain dataset (the cold run pays the compiles, the warm run reuses
them) and prints the warm per-stage wall/throughput table from
stage_stats.json.

Usage: python scripts/bench_pipeline.py \
          [--length 300000] [--strains 3] [--coverage 30] [--err 0.10]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from hairsplitter_jax.io.fasta import write_fasta
from hairsplitter_jax.pipeline.orchestrate import PipelineConfig, run_pipeline
from hairsplitter_jax.utils import sim


def build_dataset(root: str, length: int, strains: int, coverage: float, err: float, seed: int):
    rng = np.random.default_rng(seed)
    haps = sim.make_haplotypes(length, strains, 0.01, rng)
    reads = sim.simulate_reads(
        haps, coverage=coverage / strains, read_len=8000, rng=rng,
        sub_rate=err * 0.6, ins_rate=err * 0.2, del_rate=err * 0.2,
    )
    asm_path = os.path.join(root, "assembly.fasta")
    reads_path = os.path.join(root, "reads.fasta")
    write_fasta(asm_path, {"asm": haps[0]})
    sim.write_sim_fasta(reads_path, reads)
    return asm_path, reads_path


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--length", type=int, default=300_000)
    ap.add_argument("--strains", type=int, default=3)
    ap.add_argument("--coverage", type=float, default=30.0)
    ap.add_argument("--err", type=float, default=0.10)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--profile", action="store_true",
                    help="cProfile the last (warm) run and print top functions")
    args = ap.parse_args()

    root = tempfile.mkdtemp(prefix="hs_benchpipe_")
    asm_path, reads_path = build_dataset(
        root, args.length, args.strains, args.coverage, args.err, args.seed
    )
    total_kbp = sum(
        len(line.strip())
        for line in open(reads_path)
        if not line.startswith(">")
    ) / 1000.0
    print(f"dataset: {args.length/1000:.0f} kb x {args.strains} strains, "
          f"{args.coverage:.0f}x, {args.err:.0%} err, {total_kbp:.0f} read-kbp")

    walls = []
    for i in range(args.runs):
        out_dir = os.path.join(root, f"out{i}")
        prof = None
        if args.profile and i == args.runs - 1:
            import cProfile

            prof = cProfile.Profile()
            prof.enable()
        t0 = time.perf_counter()
        run_pipeline(asm_path, reads_path, out_dir, PipelineConfig())
        wall = time.perf_counter() - t0
        if prof is not None:
            prof.disable()
            import pstats

            st = pstats.Stats(prof)
            st.sort_stats("cumulative")
            st.print_stats(45)
        walls.append(wall)
        label = "cold" if i == 0 else "warm"
        print(f"run {i} ({label}): {wall:.1f} s  ({total_kbp/wall:.0f} read-kbp/s)")

    stats = json.load(open(os.path.join(root, f"out{args.runs-1}", "stage_stats.json")))
    print("warm stage table:")
    for stage, entry in stats.items():
        rates = ", ".join(
            f"{k}={v}" for k, v in entry.items() if k != "seconds"
        )
        print(f"  {stage:24s} {entry['seconds']:7.2f}s  {rates}")
    shutil.rmtree(root, ignore_errors=True)


if __name__ == "__main__":
    main()
