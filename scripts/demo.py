"""Quickstart demo: simulate a 3-strain mix, run the full pipeline, score it.

Runs on the GPU (the plain-JAX banded DP, compiled by XLA) or, with
JAX_PLATFORMS=cpu, on the CPU (the native fused aligner).

Usage: python scripts/demo.py [--length 60000]
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--length", type=int, default=60_000, help="genome length")
    ap.add_argument("--strains", type=int, default=3)
    ap.add_argument("--coverage", type=float, default=20.0, help="per strain")
    ap.add_argument("--error", type=float, default=0.10, help="total read error")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="", help="keep outputs here (default: tmp)")
    args = ap.parse_args()

    from hairsplitter_jax.io.fasta import write_fasta
    from hairsplitter_jax.io.gfa import parse_gfa
    from hairsplitter_jax.pipeline.orchestrate import PipelineConfig, run_pipeline
    from hairsplitter_jax.utils import sim as S
    from hairsplitter_jax.utils.evaluate import evaluate_phasing

    rng = np.random.default_rng(args.seed)
    print(f"simulating {args.strains} strains x {args.length/1e3:.0f} kb at "
          f"{args.coverage:.0f}x each, {args.error:.0%} read error ...")
    haps = S.make_haplotypes(args.length, args.strains, 0.01, rng)
    reads = S.simulate_reads(
        haps, coverage=args.coverage, read_len=8000, rng=rng,
        sub_rate=args.error * 0.6, ins_rate=args.error * 0.2,
        del_rate=args.error * 0.2, uniform_edges=True,
    )
    root = args.out or tempfile.mkdtemp(prefix="hs_demo_")
    os.makedirs(root, exist_ok=True)
    asm = os.path.join(root, "assembly.fasta")
    rd = os.path.join(root, "reads.fasta")
    write_fasta(asm, {"collapsed": haps[0]})  # the collapsed input assembly
    S.write_sim_fasta(rd, reads)
    print(f"{len(reads.seqs)} reads ({sum(len(s) for s in reads.seqs)/1e6:.1f} Mbp) -> {root}")

    t0 = time.time()
    final = run_pipeline(asm, rd, os.path.join(root, "out"), PipelineConfig())
    wall = time.time() - t0

    g = parse_gfa(final)
    ev = evaluate_phasing(g.segments, haps)
    lens = sorted((len(s) for s in g.segments.values()), reverse=True)
    acc, tot = 0, sum(lens)
    n50 = lens[0] if lens else 0
    for n50 in lens:
        acc += n50
        if acc * 2 >= tot:
            break
    print()
    print(f"done in {wall:.0f}s -> {final}")
    print(f"  contigs: {len(g.segments)} (N50 {n50/1e3:.0f} kb)")
    for h, r in enumerate(ev.haplotype_recovery):
        print(f"  strain {h}: {r:.1%} of its 31-mers recovered")
    print(f"  switch errors: {ev.total_switch_errors}")


if __name__ == "__main__":
    main()
