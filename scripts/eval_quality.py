"""Quality scenarios for the contiguity / low-coverage frontier.

Two scenarios from the round-4 verdict's "done" criteria:

  metagenome : 10 contigs x 100 kb, 2-3 strains each (25 strains, 1%
               divergence), 30x total coverage per contig, 10%-err 8 kb
               reads. Targets: <=35 contigs, N50 >= 120 kb, min strain
               recovery >= 0.95, <=1 switch error.
  skewed     : 3 strains x 100 kb, abundances 1.0/0.5/0.17 at 30x base
               (rare strain ~5x absolute). Target: rare recovery >= 0.9,
               0 switches.

Prints one JSON line with the metrics. Runs on the GPU or, with
JAX_PLATFORMS=cpu, on the CPU.

Usage: python scripts/eval_quality.py metagenome
       python scripts/eval_quality.py skewed [--rare-cov 5]
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
from hairsplitter_jax.io.gfa import AssemblyGraph, parse_gfa, write_gfa
from hairsplitter_jax.pipeline.orchestrate import PipelineConfig, run_pipeline
from hairsplitter_jax.utils import sim as S
from hairsplitter_jax.utils.evaluate import evaluate_phasing


def _n50(lengths: list[int]) -> int:
    lengths = sorted(lengths, reverse=True)
    total = sum(lengths)
    acc = 0
    for l in lengths:
        acc += l
        if acc * 2 >= total:
            return l
    return 0


def run_metagenome(root: str, seed: int, n_species: int = 10, length: int = 100_000,
                   coverage: float = 30.0, err: float = 0.10, use_sim2: bool = False) -> dict:
    rng = np.random.default_rng(seed)
    species = []
    strain_counts = [2, 3] * (n_species // 2) + [2] * (n_species % 2)
    for ns in strain_counts:
        base = S.random_genome(length, rng)
        species.append([base] + [S.mutate(base, 0.01, rng)[0] for _ in range(ns - 1)])

    asm = AssemblyGraph()
    per_species_reads = []
    for si, strains in enumerate(species):
        asm.add_segment(f"sp{si}", strains[0], depth=coverage)
        if use_sim2:
            from hairsplitter_jax.utils import sim2

            r = sim2.generate(strains, coverage=coverage / len(strains), seed=seed * 100 + si)
            per_species_reads.append(r)
        else:
            r = S.simulate_reads(
                strains, coverage=coverage / len(strains), read_len=8000, rng=rng,
                sub_rate=err * 0.6, ins_rate=err * 0.2, del_rate=err * 0.2,
                uniform_edges=True,
            )
            per_species_reads.append(r)
    all_names, all_seqs = [], []
    for si, r in enumerate(per_species_reads):
        for n, s in zip(r.names, r.seqs):
            all_names.append(f"sp{si}_{n}")
            all_seqs.append(s)
    reads = S.SimReads(all_names, all_seqs, [0] * len(all_seqs), [0] * len(all_seqs),
                       [1] * len(all_seqs))
    asm_path = os.path.join(root, "asm.gfa")
    reads_path = os.path.join(root, "reads.fasta")
    write_gfa(asm, asm_path)
    S.write_sim_fasta(reads_path, reads)

    t0 = time.time()
    final = run_pipeline(asm_path, reads_path, os.path.join(root, "out"), PipelineConfig())
    wall = time.time() - t0

    g = parse_gfa(final)
    lens = [len(s) for s in g.segments.values()]
    # score per species against its own strains (contigs assigned by best k-mer hit)
    recoveries: list[float] = []
    switches = 0
    for si, strains in enumerate(species):
        contigs_here = {
            n: s for n, s in g.segments.items()
            if n.startswith(f"sp{si}_") or n.split("-")[0].startswith(f"sp{si}")
        }
        if not contigs_here:
            contigs_here = dict(g.segments)
        ev = evaluate_phasing(contigs_here, strains)
        recoveries.extend(ev.haplotype_recovery)
        switches += ev.total_switch_errors
    return {
        "scenario": "metagenome" + ("+sim2" if use_sim2 else ""),
        "contigs": len(g.segments),
        "n50": _n50(lens),
        "recovery_mean": round(float(np.mean(recoveries)), 4),
        "recovery_min": round(float(np.min(recoveries)), 4),
        "switches": switches,
        "wall_s": round(wall, 1),
    }


def run_skewed(root: str, seed: int, length: int = 100_000, base_cov: float = 30.0,
               rare_cov: float = 5.0, err: float = 0.10, use_sim2: bool = False) -> dict:
    rng = np.random.default_rng(seed)
    haps = S.make_haplotypes(length, 3, 0.01, rng)
    ab = [1.0, 0.5, rare_cov / base_cov]
    asm_path = os.path.join(root, "asm.fasta")
    reads_path = os.path.join(root, "reads.fasta")
    write_fasta(asm_path, {"collapsed": haps[0]})
    if use_sim2:
        from hairsplitter_jax.utils import sim2

        reads2 = sim2.generate(haps, coverage=base_cov, seed=seed + 1, abundances=ab)
        sim2.write_fasta(reads_path, reads2)
    else:
        reads = S.simulate_reads(
            haps, coverage=base_cov, read_len=8000, rng=rng,
            sub_rate=err * 0.6, ins_rate=err * 0.2, del_rate=err * 0.2,
            abundances=ab, uniform_edges=True,
        )
        S.write_sim_fasta(reads_path, reads)
    t0 = time.time()
    final = run_pipeline(asm_path, reads_path, os.path.join(root, "out"), PipelineConfig())
    wall = time.time() - t0
    g = parse_gfa(final)
    ev = evaluate_phasing(g.segments, haps)
    return {
        "scenario": "skewed" + ("+sim2" if use_sim2 else ""),
        "contigs": len(g.segments),
        "n50": _n50([len(s) for s in g.segments.values()]),
        "recovery": [round(r, 4) for r in ev.haplotype_recovery],
        "rare_recovery": round(ev.haplotype_recovery[-1], 4),
        "switches": ev.total_switch_errors,
        "wall_s": round(wall, 1),
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("scenario", choices=["metagenome", "skewed"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rare-cov", type=float, default=5.0)
    ap.add_argument("--species", type=int, default=10)
    ap.add_argument("--length", type=int, default=100_000)
    ap.add_argument("--keep", default="", help="keep outputs here")
    ap.add_argument(
        "--sim2", action="store_true",
        help="use the INDEPENDENT read simulator (utils/sim2.py: log-normal "
        "lengths, per-read quality, error bursts, hp run-length noise, junk "
        "reads) — evidence de-correlation, round-4 verdict weak #1",
    )
    args = ap.parse_args()
    root = args.keep or tempfile.mkdtemp(prefix=f"hs_eval_{args.scenario}_")
    os.makedirs(root, exist_ok=True)
    try:
        if args.scenario == "metagenome":
            res = run_metagenome(root, args.seed, n_species=args.species,
                                 length=args.length, use_sim2=args.sim2)
        else:
            res = run_skewed(
                root, args.seed, rare_cov=args.rare_cov, length=args.length,
                use_sim2=args.sim2,
            )
        print(json.dumps(res))
    finally:
        if not args.keep:
            shutil.rmtree(root, ignore_errors=True)


if __name__ == "__main__":
    main()
