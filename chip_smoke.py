"""Smoke run of hairsplitter_jax on an NVIDIA GPU: the quickest proof that
the whole program starts, computes right and finishes on the card.

    python chip_smoke.py               # phases 1-6 below, one process, one GPU
    python chip_smoke.py --four-cards  # only: 1-process vs 4-process pipeline

Phases (one process; any failure exits non-zero, nothing is passed over):
  1. device gate: a GPU or exit; card name/power limit (nvidia-smi, in a
     child that imports no JAX), compile-cache dir, native host library;
  2. the fused mapping call at production shapes (BandSpec(256, 128), 16 x
     2048 jobs, both modes) against the native C++ aligner on the host -
     bit-identical;
  3. timing: the fused call per 2048-row bucket (and the DP's share), and
     end to end through `map_reads` (100 kb x 36x, 8 kb reads);
  4. the stage 3/4 device ops on windows captured from phase 5's pipeline,
     re-run on the CPU backend: outputs equal; and the chi² gates' f32
     decisions against the CPU backend's f64 host path: equal;
  5. the full pipeline through `cli.main` on a 300 kb assembly, 3 strains at
     1% divergence, 30x of 8 kb sim2 reads (seed 7), cold and warm, scored
     against the truth and against the CPU's scores for the same seed;
  6. the card-only tests (`pytest -m gpu`), in this process.

The last line of stdout is {"ok": true, "device": {...}}, printed only when
every phase passed. A machine-readable report goes to
chiprun_out/chip_smoke_report.json.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
REPORT_DIR = os.path.join(ROOT, "chiprun_out")
SEED = 7
# per-strain recovery and switch errors of the same pipeline on the same
# seed-7 dataset on the CPU backend (JAX_PLATFORMS=cpu); phase 5 holds the
# GPU run to these
CPU_RECOVERY = (0.9755575557555756, 0.9647398073140647, 0.9664166416641664)
CPU_SWITCH_ERRORS = 0
RECOVERY_SLACK = 0.005


def card_info() -> str:
    """`name, power.limit` of the card(s), from nvidia-smi in a child."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()


def device_gate() -> dict:
    """platform/kind/count of JAX's devices; exits unless they are GPUs."""
    from hairsplitter_jax.runtime import device_summary

    dev = device_summary()
    if dev["platform"] != "gpu":
        raise SystemExit(f"chip_smoke: needs a GPU, JAX found {dev}")
    return dev


def make_dataset(root: str, length: int = 300_000, seed: int = SEED):
    """§1 dataset: 3 strains at 1% divergence, 30x total of ~8 kb sim2 reads
    (~10% error), assembly = strain 0, FASTA. Imports no JAX."""
    import numpy as np

    from hairsplitter_jax.io.fasta import write_fasta
    from hairsplitter_jax.utils import sim as hsim
    from hairsplitter_jax.utils import sim2

    haps = hsim.make_haplotypes(length, 3, 0.01, np.random.default_rng(seed))
    reads = sim2.generate(haps, coverage=30.0 / 3, seed=seed)
    asm = os.path.join(root, "asm.fasta")
    rds = os.path.join(root, "reads.fasta")
    write_fasta(asm, {"asm": haps[0]})
    sim2.write_fasta(rds, reads)
    return asm, rds, haps, sum(len(s) for s in reads.seqs)


def _best_ms(fn, reps: int = 5) -> float:
    import jax

    jax.block_until_ready(fn())
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        best = min(best, time.perf_counter() - t0)
    return best * 1e3


def phase_kernel(report: dict, K: int = 16, N: int = 2048) -> None:
    """Phases 2 and 3 (device part): correctness and timing of the fused
    mapping call at production shapes."""
    import jax
    import numpy as np

    from hairsplitter_jax import native
    from hairsplitter_jax.ops.align import BandSpec, banded_align_batch
    from hairsplitter_jax.ops.align_device import (
        align_traceback_rows_multi_packed,
        expand_rows_host,
        pack_nibbles_host,
    )
    from hairsplitter_jax.utils.sim import simulate_dp_jobs

    spec = BandSpec(chunk=256, band=128)
    B, T = spec.chunk, spec.t_width
    buckets = [
        simulate_dp_jobs(np.random.default_rng(100 + k), N, spec, 0.05 + 0.05 * k / (K - 1))
        for k in range(K)
    ]
    q, ql, t, tl = (np.stack([b[i] for b in buckets]) for i in range(4))
    modes = np.broadcast_to((np.arange(N) % 2).astype(np.int32), (K, N)).copy()
    dev = [jax.device_put(a) for a in (pack_nibbles_host(q), ql, pack_nibbles_host(t), tl, modes)]

    def call():
        return align_traceback_rows_multi_packed(*dev, spec=spec, B=B, T=T)

    t0 = time.perf_counter()
    compiled = align_traceback_rows_multi_packed.lower(*dev, spec=spec, B=B, T=T).compile()
    print(f"phase 2: compiled fused call K={K} N={N} in {time.perf_counter() - t0:.1f}s")
    print(f"phase 2: memory_analysis {compiled.memory_analysis()}")
    got = np.asarray(call())
    assert got.shape == (K, N, 16 + B), got.shape
    n_jobs = 0
    for k in range(K):
        ops_g, cost_g, clip_g = expand_rows_host(got[k], q[k], t[k], spec)
        ops_n, cost_n, clip_n = native.banded_align_tb(q[k], ql[k], t[k], tl[k], modes[k], spec.band)
        assert np.array_equal(cost_g, cost_n) and np.array_equal(clip_g, clip_n), f"bucket {k}"
        assert all(np.array_equal(a, b) for a, b in zip(ops_g, ops_n)), f"bucket {k} ops"
        n_jobs += len(ops_g)
    print(f"phase 2: fused uint8 [K, N, 16+B] decodes to CIGARs, costs, clips identical to "
          f"native hs_banded_align_tb on {n_jobs} jobs: ok")

    ms_fused = _best_ms(call)
    qf = jax.device_put(q.reshape(K * N, B))
    tf = jax.device_put(t.reshape(K * N, T))
    qlf, tlf = jax.device_put(ql.reshape(-1)), jax.device_put(tl.reshape(-1))
    dp = jax.jit(banded_align_batch, static_argnames=("spec",))
    ms_dp = _best_ms(lambda: dp(qf, qlf, tf, tlf, spec=spec))
    report["kernel"] = {
        "K": K, "N": N, "chunk": B, "band": spec.band,
        "fused_ms_per_bucket": ms_fused / K,
        "dp_ms_per_bucket": ms_dp / K,
        "readout_traceback_share": 1.0 - ms_dp / ms_fused,
        "cells_per_s": K * N * B * spec.band / (ms_fused / 1e3),
    }
    print(f"phase 3: fused call per 2048-row bucket {ms_fused / K:.4f} ms; DP alone "
          f"{ms_dp / K:.4f} ms (readout+traceback {100 * (1 - ms_dp / ms_fused):.1f}%)")


def _times(run, reps: int = 7) -> tuple[list[float], object]:
    """Wall seconds of `reps` runs after one warm-up, and the last result."""
    res, out = run(), []
    for _ in range(reps):
        t0 = time.perf_counter()
        res = run()
        out.append(time.perf_counter() - t0)
    return out, res


def phase_mapping(report: dict, size: int = 100_000) -> None:
    """Phase 3 (end to end): `map_reads` wall time on the 100 kb x 36x, 8 kb,
    10%-error set, and the DP stage alone (`run_jobs`: packing, device
    call, CIGAR decode) on its jobs."""
    import numpy as np

    from hairsplitter_jax.core import mapping
    from hairsplitter_jax.utils.sim import random_genome, simulate_reads

    rng = np.random.default_rng(1)
    genome = random_genome(size, rng)
    sim = simulate_reads(
        [genome], coverage=36, read_len=8000, rng=rng,
        sub_rate=0.05, ins_rate=0.025, del_rate=0.025,
    )
    kbp = sum(len(s) for s in sim.seqs) / 1e3
    cfg = mapping.MapConfig()
    run_jobs, jobs = mapping.run_jobs, []

    def capture(js, c):  # keep the first call's jobs (the main pass)
        if not jobs:
            jobs.extend(js)
        return run_jobs(js, c)

    mapping.run_jobs = capture
    try:
        tm, alns = _times(lambda: mapping.map_reads({"c": genome}, sim.seqs, cfg))
    finally:
        mapping.run_jobs = run_jobs
    td, _ = _times(lambda: run_jobs(jobs, cfg))
    assert len(alns) > 0.9 * len(sim.seqs)
    report["mapping"] = {
        "map_reads_median_s": float(np.median(tm)), "map_reads_s": tm,
        "read_kbp_per_s": kbp / float(np.median(tm)),
        "run_jobs_median_s": float(np.median(td)), "run_jobs_s": td, "jobs": len(jobs),
    }
    print(f"phase 3: map_reads {size // 1000} kb x 36x ({kbp:.0f} kbp) median {np.median(tm):.3f} s "
          f"of {[round(x, 3) for x in tm]} = {kbp / np.median(tm):.1f} read-kbp/s; DP stage "
          f"(run_jobs, {len(jobs)} jobs) median {np.median(td):.4f} s of {[round(x, 4) for x in td]}")


class _Recorder:
    """Wraps the pipeline's device-op entry points for one run and keeps
    the host copies of the first `keep` calls' arguments."""

    SITES = (
        ("hairsplitter_jax.pipeline.call_variants", "_window_stats_batch"),
        ("hairsplitter_jax.ops.variants", "window_error_stats_host"),
        ("hairsplitter_jax.ops.variants", "pairwise_column_correlation_packed"),
        ("hairsplitter_jax.ops.variants", "partition_column_keep_packed"),
        ("hairsplitter_jax.ops.variants", "partition_rescue_keep_packed"),
        ("hairsplitter_jax.ops.cluster", "sims_diffs_packed_pull"),
        ("hairsplitter_jax.ops.cluster", "sims_diffs_packed"),
        ("hairsplitter_jax.ops.phase", "phase_windows_sub_jit"),
        ("hairsplitter_jax.ops.phase", "phase_windows_jit"),
    )

    def __init__(self, keep: int = 2):
        self.keep = keep
        self.calls: dict[str, list] = {}
        self.saved = []

    def __enter__(self):
        import importlib

        import jax
        import numpy as np

        for mod_name, name in self.SITES:
            mod = importlib.import_module(mod_name)
            fn = getattr(mod, name)
            self.saved.append((mod, name, fn))

            def wrapped(*args, _fn=fn, _name=name, **kw):
                rec = self.calls.setdefault(_name, [])
                traced = any(isinstance(a, jax.core.Tracer) for a in args)
                if len(rec) < self.keep and not traced:
                    rec.append(([np.asarray(a) for a in args], dict(kw)))
                return _fn(*args, **kw)

            setattr(mod, name, wrapped)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


def _bits(p):
    import numpy as np

    return np.unpackbits(np.asarray(p), axis=-1, bitorder="little").astype(np.float32)


def _unbits(b, n: int):
    import numpy as np

    return np.unpackbits(np.asarray(b), axis=-1, bitorder="little")[..., :n].astype(bool)


def phase_chi2_vs_host(report: dict, rec: _Recorder) -> None:
    """Phase 4, chi² gates: on the captured real windows, the decisions of
    the GPU's f32 device path equal those of the host path the CPU backend
    takes (`pipeline/call_variants.py` twins, f64 chi²): correlated column
    pairs and flips, kept columns, rescued columns."""
    import numpy as np

    from hairsplitter_jax.ops import variants as V
    from hairsplitter_jax.pipeline import call_variants as C

    seen = {}
    for args, _ in rec.calls.get("pairwise_column_correlation_packed", []):
        Ap, Rp, pos, thr, span, margin, margin_min = args
        S = Ap.shape[0]
        A, Rf = _bits(Ap), _bits(Rp)
        corr_d, flip_d = V.pairwise_column_correlation(A, Rf, pos, thr, span, margin, margin_min)
        corr_h, flip_h = C.pairwise_correlation_host(
            A, Rf, pos, float(thr), int(span), float(margin), float(margin_min)
        )
        assert np.array_equal(_unbits(corr_d, S), corr_h), "correlated pairs: GPU != host"
        assert np.array_equal(_unbits(flip_d, S), flip_h), "flips: GPU != host"
        seen.setdefault("pairwise", []).append(int(corr_h.sum()))
    for args, _ in rec.calls.get("partition_column_keep_packed", []):
        P1, P0, Ap, Rp, col_size, thr = args
        S = Ap.shape[0]
        keep_d = V.partition_column_keep(P1, P0, _bits(Ap), _bits(Rp), col_size, thr)
        keep_h = C.partition_column_keep_host(P1, P0, _bits(Ap), _bits(Rp), col_size, float(thr))
        assert np.array_equal(_unbits(keep_d, S), keep_h), "kept columns: GPU != host"
        seen.setdefault("keep", []).append(int(keep_h.sum()))
    for args, _ in rec.calls.get("partition_rescue_keep_packed", []):
        P1, P0, Arp, Rrp, thr = args
        S = Arp.shape[0]
        ok_d = V.partition_rescue_keep(P1, P0, _bits(Arp), _bits(Rrp), thr)
        ok_h = C.partition_rescue_keep_host(P1, P0, _bits(Arp), _bits(Rrp), float(thr))
        assert np.array_equal(_unbits(ok_d, S), ok_h), "rescued columns: GPU != host"
        seen.setdefault("rescue", []).append(int(ok_h.sum()))
    assert "pairwise" in seen and "keep" in seen, f"chi² gates never ran on the device: {seen}"
    report["chi2_vs_host"] = seen
    print(f"phase 4: chi² gates GPU f32 == CPU-backend host f64 on real windows "
          f"(decisions counted per window: {json.dumps(seen)})")


def phase_ops_vs_cpu(report: dict, rec: _Recorder) -> None:
    """Phase 4: the stage 3/4 jitted ops on captured real windows, on the
    GPU and on the CPU backend; outputs must be equal."""
    import jax
    import numpy as np

    from hairsplitter_jax.ops.cluster import chinese_whispers_matmul, sims_diffs
    from hairsplitter_jax.ops.phase import phase_contigs_batch, phase_window_core
    from hairsplitter_jax.ops.variants import (
        column_stats,
        pairwise_column_correlation,
        partition_column_keep,
        partition_rescue_keep,
    )

    cpu = jax.devices("cpu")[0]
    cases = []  # (name, fn, args)
    # pileup windows (trimer codes [R, P]) with their contig codes [P]: the
    # big ones went to the device batch, the small ones to the host twins
    windows = [(a[0][0], a[1][0]) for a, _ in rec.calls.get("_window_stats_batch", [])]
    windows += [tuple(a) for a, _ in rec.calls.get("window_error_stats_host", [])]
    for tri, _ in windows:
        cases.append(("column_stats", column_stats, (tri,)))
    for args, _ in rec.calls.get("pairwise_column_correlation_packed", []):
        Ap, Rp, *rest = args
        cases.append(("pairwise_column_correlation", pairwise_column_correlation, (_bits(Ap), _bits(Rp), *rest)))
    for args, _ in rec.calls.get("partition_column_keep_packed", []):
        P1, P0, Ap, Rp, col_size, thr = args
        cases.append(("partition_column_keep", partition_column_keep, (P1, P0, _bits(Ap), _bits(Rp), col_size, thr)))
    for args, _ in rec.calls.get("partition_rescue_keep_packed", []):
        P1, P0, Arp, Rrp, thr = args
        cases.append(("partition_rescue_keep", partition_rescue_keep, (P1, P0, _bits(Arp), _bits(Rrp), thr)))
    AR = [a for n in ("sims_diffs_packed_pull", "sims_diffs_packed") for a, _ in rec.calls.get(n, [])]
    for Apk, Rpk, *_ in AR:
        cases.append(("sims_diffs", sims_diffs, (_bits(Apk), _bits(Rpk))))
    for name in ("phase_windows_sub_jit", "phase_windows_jit"):
        for args, kw in rec.calls.get(name, []):
            if name == "phase_windows_sub_jit":
                sims, diffs, masks, inits, err = args
                sim, diff = sims[0], diffs[0]
            else:
                sim, diff, masks, inits, err = args
            adj, _ = jax.jit(phase_window_core)(sim, diff, masks[0], inits[0], err)
            adj = np.asarray(adj).astype(np.float32)
            cases.append(("chinese_whispers_matmul", chinese_whispers_matmul, (adj, inits[0][0], masks[0])))
    # phase_contigs_batch: one captured pileup window + its contig codes,
    # with read indicators from a captured sims_diffs call cropped to it
    if windows and AR:
        tri, codes = windows[0]
        A, Rm = _bits(AR[0][0]), _bits(AR[0][1])
        r = min(tri.shape[0], A.shape[0])
        S = A.shape[1]
        inits = np.zeros((8, r), np.int32)
        for k, col in enumerate(np.linspace(0, S - 1, 8).astype(int)):
            alt = A[:r, col] > 0
            inits[k] = np.where(alt, int(np.argmax(alt)), int(np.argmax(~alt)))
        cases.append((
            "phase_contigs_batch", phase_contigs_batch,
            (tri[None, :r], codes[None], A[None, :r], Rm[None, :r], np.ones((1, r), bool), inits[None]),
        ))
    seen = {}
    for name, fn, args in cases:
        g = jax.tree_util.tree_map(np.asarray, fn(*args))
        with jax.default_device(cpu):
            c = jax.tree_util.tree_map(np.asarray, fn(*args))
        for a, b in zip(jax.tree_util.tree_leaves(g), jax.tree_util.tree_leaves(c)):
            assert a.shape == b.shape and np.array_equal(a, b), f"{name}: GPU != CPU backend"
        shapes = [tuple(np.shape(a)) for a in args]
        seen.setdefault(name, []).append(shapes)
    required = {
        "column_stats", "pairwise_column_correlation", "partition_column_keep",
        "sims_diffs", "chinese_whispers_matmul", "phase_contigs_batch",
    }
    missing = required - set(seen)
    assert not missing, f"pipeline never reached the device path of {sorted(missing)}"
    report["ops_vs_cpu"] = seen
    for name, shapes in seen.items():
        print(f"phase 4: {name} GPU == CPU backend on {len(shapes)} real window(s) {shapes[0]}")


def phase_pipeline(report: dict, root: str, length: int = 300_000) -> _Recorder:
    """Phase 5: cli.main cold (recording the device ops' inputs) and warm."""
    import jax

    from hairsplitter_jax import cli
    from hairsplitter_jax.io.gfa import parse_gfa
    from hairsplitter_jax.utils.evaluate import evaluate_phasing

    t0 = time.perf_counter()
    asm, rds, haps, read_bp = make_dataset(root, length)
    t_data = time.perf_counter() - t0
    print(f"phase 5: dataset {read_bp / 1e6:.2f} Mbp of reads in {t_data:.1f}s (set-up)")
    walls = {}
    with _Recorder() as rec:
        t0 = time.perf_counter()
        assert cli.main(["-i", asm, "-f", rds, "-o", os.path.join(root, "cold"), "-F"]) == 0
        walls["cold"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    assert cli.main(["-i", asm, "-f", rds, "-o", os.path.join(root, "warm"), "-F"]) == 0
    walls["warm"] = time.perf_counter() - t0
    with open(os.path.join(root, "warm", "stage_stats.json")) as f:
        stages = {k: v["seconds"] for k, v in json.load(f).items()}
    peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")
    final = os.path.join(root, "warm", "hairsplitter_final_assembly.gfa")
    ev = evaluate_phasing(parse_gfa(final).segments, haps)
    with open(final, "rb") as f, open(os.path.join(root, "cold", "hairsplitter_final_assembly.gfa"), "rb") as g:
        same = f.read() == g.read()
    report["pipeline"] = {
        "read_mbp": read_bp / 1e6, "cold_s": walls["cold"], "warm_s": walls["warm"],
        "warm_read_kbp_per_s": read_bp / 1e3 / walls["warm"],
        "stages_warm_s": stages, "peak_bytes_in_use": peak,
        "recovery": ev.haplotype_recovery, "switch_errors": ev.total_switch_errors,
        "contigs": len(ev.contigs), "cold_warm_gfa_identical": same,
    }
    print(f"phase 5: pipeline wall cold {walls['cold']:.2f} s (with compiles), warm {walls['warm']:.2f} s "
          f"({read_bp / 1e3 / walls['warm']:.1f} read-kbp/s); peak_bytes_in_use {peak}")
    print(f"phase 5: warm stage seconds {json.dumps(stages)}")
    print(f"phase 5: recovery {[round(x, 4) for x in ev.haplotype_recovery]} "
          f"(CPU {[round(x, 4) for x in CPU_RECOVERY]}), switch errors {ev.total_switch_errors} "
          f"(CPU {CPU_SWITCH_ERRORS}), {len(ev.contigs)} contigs; cold == warm GFA: {same}")
    for got, cpu_score in zip(ev.haplotype_recovery, CPU_RECOVERY):
        assert got >= cpu_score - RECOVERY_SLACK, (ev.haplotype_recovery, CPU_RECOVERY)
    assert ev.total_switch_errors <= CPU_SWITCH_ERRORS, ev.total_switch_errors
    return rec


def phase_gpu_tests() -> None:
    """Phase 6: the card-only tests, in this process (a second JAX process
    would not get the card's memory)."""
    import pytest

    os.environ["HS_GPU_TESTS"] = "1"
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider", os.path.join(ROOT, "tests", "test_gpu.py")])
    assert rc == 0, f"pytest -m gpu exited {rc}"
    print("phase 6: pytest -m gpu: ok")


def main_one_card() -> None:
    plats = os.environ.get("JAX_PLATFORMS", "")
    if plats and "cpu" not in plats.split(","):
        os.environ["JAX_PLATFORMS"] = plats + ",cpu"  # phase 4 compares against it
    from hairsplitter_jax import native
    from hairsplitter_jax.runtime import init_compile_cache

    cache = init_compile_cache()
    dev = device_gate()
    card = card_info()
    print(f"phase 1: device_kind {dev['kind']!r}, {dev['count']} device(s); card {card}")
    print(f"phase 1: compile cache {cache}; host: {native.status()}")
    assert native.get_lib() is not None, "native host library did not load"
    report = {"device": dev, "card": card}
    t_all = time.perf_counter()
    phase_kernel(report)
    phase_mapping(report)
    with tempfile.TemporaryDirectory(prefix="hs_smoke_") as root:
        rec = phase_pipeline(report, root)
    phase_ops_vs_cpu(report, rec)
    phase_chi2_vs_host(report, rec)
    phase_gpu_tests()
    report["wall_s"] = time.perf_counter() - t_all
    os.makedirs(REPORT_DIR, exist_ok=True)
    with open(os.path.join(REPORT_DIR, "chip_smoke_report.json"), "w") as f:
        json.dump(report, f, indent=1, default=str)
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": dev}))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_all(cmds: list[list[str]], env: dict, logs: list[str], timeout: float) -> None:
    """Run the commands concurrently, each child's output to its own log
    file (a full pipe would stall a child mid-collective and hang its
    peers); fail - and end the others - as soon as one fails or time runs
    out."""
    files = [open(log, "w") for log in logs]
    procs = [subprocess.Popen(c, env=env, stdout=f, stderr=subprocess.STDOUT) for c, f in zip(cmds, files)]
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            bad = [i for i, p in enumerate(procs) if p.returncode not in (None, 0)]
            if bad or time.monotonic() > deadline:
                tail = open(logs[bad[0] if bad else 0]).read()[-3000:]
                raise SystemExit(f"chip_smoke: process {bad or 'timeout'} failed:\n{tail}")
            time.sleep(0.5)
        bad = [i for i, p in enumerate(procs) if p.returncode != 0]
        if bad:
            raise SystemExit(f"chip_smoke: process {bad} failed:\n{open(logs[bad[0]]).read()[-3000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in files:
            f.close()


def main_four_cards(length: int = 300_000, cpu_devices: int = 0) -> None:
    """A single-process pipeline and the same pipeline as 4 processes, one
    per card, with a local coordinator; the final GFAs must be
    byte-identical. This parent imports no JAX (it would take a card's
    memory). The children's logs go to chiprun_out/four_cards/.
    cpu_devices > 0 rehearses the same path on the CPU backend."""
    n = 4
    dist = [sys.executable, "-m", "hairsplitter_jax.parallel.distributed"]
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    if cpu_devices:
        env["JAX_PLATFORMS"] = "cpu"
        dist += ["--cpu-devices", str(cpu_devices)]
    else:
        card = card_info()
    logs = os.path.join(REPORT_DIR, "four_cards")
    os.makedirs(logs, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="hs_smoke4_") as root:
        asm, rds, _, read_bp = make_dataset(root, length)
        io = ["-i", asm, "-f", rds]
        t0 = time.perf_counter()
        _run_all(
            [dist + ["--num-processes", "1", *io, "-o", os.path.join(root, "p1")]],
            env if cpu_devices else dict(env, CUDA_VISIBLE_DEVICES="0"),
            [os.path.join(logs, "single.log")], timeout=240,
        )
        t1 = time.perf_counter() - t0
        port = _free_port()
        cmds = [
            dist + [
                "--coordinator", f"localhost:{port}", "--num-processes", str(n),
                "--process-id", str(i), *([] if cpu_devices else ["--local-device-ids", str(i)]),
                *io, "-o", os.path.join(root, "p4"),
            ]
            for i in range(n)
        ]
        t0 = time.perf_counter()
        _run_all(cmds, env, [os.path.join(logs, f"p{i}.log") for i in range(n)], timeout=240)
        t4 = time.perf_counter() - t0
        gfa = "hairsplitter_final_assembly.gfa"
        with open(os.path.join(root, "p1", gfa), "rb") as f1, open(os.path.join(root, "p4", gfa), "rb") as f4:
            a, b = f1.read(), f4.read()
        assert a == b, "4-process GFA differs from the 1-process GFA"
    with open(os.path.join(logs, "p0.log")) as f:
        dev_line = [ln for ln in f.read().splitlines() if ln.startswith("device: ")][-1]
    dev = json.loads(dev_line[len("device: "):].split("; host: ")[0])
    print(f"four cards: {read_bp / 1e6:.2f} Mbp; 1 process {t1:.1f} s, {n} processes {t4:.1f} s; "
          f"final GFAs byte-identical ({len(a)} bytes); process 0: {dev_line}")
    if not cpu_devices:
        assert dev["platform"] == "gpu" and dev["count"] == n, dev
        print(f"card: {card}")
    print(json.dumps({"ok": True, "device": dev}))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true", help="only the 4-process pipeline check")
    args = ap.parse_args()
    if args.four_cards:
        main_four_cards()
    else:
        main_one_card()


if __name__ == "__main__":
    main()
