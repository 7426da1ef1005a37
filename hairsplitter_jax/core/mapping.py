"""Read→assembly mapping: seeding + chaining + batched banded DP + stitching.

This is the framework's replacement for the reference's stage-2 shell-out
(`hairsplitter.py:629-630`: `minimap2 -a --secondary=no -M 0.05 -Y` piped
through awk). Chains of exact minimizer anchors pin the alignment; the base
pairs between consecutive pins become fixed-shape banded-DP chunks that are
batched across all reads into single device calls; chunk CIGARs are stitched
on host. Reads may produce several alignments on disjoint intervals
(primary + supplementary semantics, `src/input_output.cpp:472-476`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from ..constants import encode_seq, revcomp_codes
from ..io.cigar import compress_cigar
from ..ops.align import (
    BandSpec,
    Q_SENTINEL,
    T_SENTINEL,
    banded_align_batch,
    readout,
    traceback_batch,
)
from .datatypes import Alignment
from .seeding import MinimizerIndex, find_chains, find_chains_batch


@dataclass(frozen=True)
class MapConfig:
    k: int = 15
    w: int = 10
    spec: BandSpec = field(default_factory=BandSpec)
    min_anchors: int = 4
    max_occ: int = 64
    # rows per device DP call; runs of more than one bucket go through the
    # multi-bucket call (K buckets in one device call, K in {16, 4, 1}), and
    # runs of at most 256 jobs (polish remaps) use a 256-row bucket
    batch: int = 2048
    # minimum identity to keep an alignment (minimap2 -M-ish sanity filter)
    max_divergence: float = 0.35
    # reads with no accepted alignment get a second pass with shorter, denser
    # minimizers (a 15-mer survives 25%+ read error with P<0.01, so very
    # noisy reads starve of anchors; minimap2's presets hide the same knob)
    rescue: bool = True
    rescue_k: int = 11
    rescue_w: int = 6
    # homopolymer-compressed seeding (minimap2 -H): the reference's pacbio
    # preset is `minimap2 -x map-pb` which seeds in HPC space
    # (`hairsplitter.py:629`) — CLR-profile errors are hp-indel-dominated,
    # so raw k19 minimizers starve of anchors at ~15% error
    hpc: bool = False

    @property
    def maxdrift(self) -> int:
        return min(self.spec.dl, self.spec.dr) - 8


def select_pins(qa: np.ndarray, ta: np.ndarray, cfg: MapConfig) -> list[tuple[int, int]]:
    """Subset of chain anchors used as exact pins between DP chunks.

    Greedy: reach as far as the chunk geometry allows; across anchor deserts
    synthesize interpolated pins (approximate, absorbed by the band).
    Dispatches to the native twin when available (bit-identical)."""
    B = cfg.spec.chunk
    T = cfg.spec.t_width
    md = cfg.maxdrift

    from .. import native as _native

    pairs = _native.select_pins(np.asarray(qa), np.asarray(ta), B, T, md)
    if pairs is not None:
        pins = [(int(a), int(b)) for a, b in pairs]
        out = [pins[0]]
        for p in pins[1:]:
            if p[0] > out[-1][0] and p[1] > out[-1][1]:
                out.append(p)
        return out

    pins = [(int(qa[0]), int(ta[0]))]
    idx = 0
    n = qa.size
    while idx < n - 1:
        best = None
        for j2 in range(idx + 1, n):
            dq = int(qa[j2] - qa[idx])
            dt = int(ta[j2] - ta[idx])
            if dq > B or dt > T or abs(dt - dq) > md:
                break
            best = j2
        if best is None:
            nxt = idx + 1
            dq = int(qa[nxt] - qa[idx])
            dt = int(ta[nxt] - ta[idx])
            npieces = max(
                math.ceil(dq / B), math.ceil(dt / T), math.ceil(abs(dt - dq) / max(1, md)), 1
            )
            for m in range(1, npieces + 1):
                pins.append(
                    (int(qa[idx] + round(dq * m / npieces)), int(ta[idx] + round(dt * m / npieces)))
                )
            idx = nxt
        else:
            pins.append((int(qa[best]), int(ta[best])))
            idx = best
    # drop degenerate pins
    out = [pins[0]]
    for p in pins[1:]:
        if p[0] > out[-1][0] and p[1] > out[-1][1]:
            out.append(p)
    return out


@dataclass
class _Job:
    q: np.ndarray  # int8, len <= B
    t: np.ndarray  # int8, len <= T
    mode: int  # 0 global, 1 extension
    reversed_: bool  # ops must be reversed before stitching (left extension)


def _pack_jobs(jobs: list[_Job], n: int, B: int, T: int):
    """Fixed-shape job arrays for the first len(jobs) of n rows: sentinel-
    padded q [n, B] / t [n, T], lengths and modes."""
    qb = np.full((n, B), Q_SENTINEL, dtype=np.int8)
    tb = np.full((n, T), T_SENTINEL, dtype=np.int8)
    qlens = np.zeros(n, dtype=np.int32)
    tlens = np.zeros(n, dtype=np.int32)
    modes = np.zeros(n, dtype=np.int32)
    for i, job in enumerate(jobs):
        qb[i, : len(job.q)] = job.q
        tb[i, : len(job.t)] = job.t
        qlens[i] = len(job.q)
        tlens[i] = len(job.t)
        modes[i] = job.mode
    return qb, tb, qlens, tlens, modes


def _job_result(job: _Job, ops, cost, clip) -> dict:
    return {"ops": ops[::-1] if job.reversed_ else ops, "cost": int(cost), "clip": int(clip)}


def run_jobs(jobs: list[_Job], cfg: MapConfig) -> list[dict]:
    """Align all jobs; return per-job results with expanded ops, cost and
    trailing-query soft clip length. The implementation is
    `runtime.dp_kernel` of the default device's platform."""
    from .. import native as _native
    from ..runtime import dp_kernel, platform

    if dp_kernel(platform()) == "jnp":
        return _run_jobs_device_tb(jobs, cfg)
    if _native.get_lib() is not None:
        return _run_jobs_native(jobs, cfg)
    return _run_jobs_host(jobs, cfg)


def _run_jobs_host(jobs: list[_Job], cfg: MapConfig) -> list[dict]:
    """CPU without the native library (HS_NATIVE=0): the jnp DP on XLA-CPU
    plus the numpy readout and traceback, bucket by bucket."""
    spec = cfg.spec
    B, T = spec.chunk, spec.t_width
    results: list[dict] = [None] * len(jobs)
    for lo in range(0, len(jobs), cfg.batch):
        sub = jobs[lo : lo + cfg.batch]
        npad = max(32, 1 << (len(sub) - 1).bit_length())
        qb, tb, qlens, tlens, modes = _pack_jobs(sub, npad, B, T)
        res = banded_align_batch(qb, qlens, tb, tlens, spec)
        cost, start_i, start_b, clip = readout(res, qlens, tlens, modes, spec)
        ops_list = traceback_batch(np.asarray(res["bp"]), qb, tb, start_i, start_b, spec)
        for i, job in enumerate(sub):
            results[lo + i] = _job_result(job, ops_list[i], cost[i], clip[i])
    return results


def _run_jobs_native(jobs: list[_Job], cfg: MapConfig) -> list[dict]:
    """CPU-backend job runner: the whole fused DP + readout + traceback in
    threaded native C++ (`hs_banded_align_tb`), bit-identical to the jnp
    scan + host readout/traceback pair. No shape bucketing needed — the
    scalar loop is ragged-friendly; one call covers all jobs."""
    from .. import native as _native

    spec = cfg.spec
    qb, tb, qlens, tlens, modes = _pack_jobs(jobs, len(jobs), spec.chunk, spec.t_width)
    ops_list, cost, clip = _native.banded_align_tb(qb, qlens, tb, tlens, modes, spec.band)
    return [_job_result(job, ops_list[i], cost[i], clip[i]) for i, job in enumerate(jobs)]


def _run_jobs_device_tb(jobs: list[_Job], cfg: MapConfig) -> list[dict]:
    """Device path: DP + readout + row-lockstep traceback in ONE device call
    per bucket (`ops/align_device.py`), nibble-packed uploads; every bucket
    is dispatched before the first result is pulled, so device compute, the
    transfers and host CIGAR assembly overlap."""
    from ..ops.align_device import (
        align_traceback_rows_packed,
        expand_rows_host,
        pack_nibbles_host,
    )

    spec = cfg.spec
    B, T = spec.chunk, spec.t_width
    # two fixed bucket shapes: the production bucket, and a small one so
    # single-group polish remaps don't pad to the full bucket
    bucket = cfg.batch if len(jobs) > 256 else min(256, cfg.batch)
    if len(jobs) > bucket:
        return _run_jobs_device_tb_multi(jobs, cfg, bucket)
    qb, tb, qlens, tlens, modes = _pack_jobs(jobs, bucket, B, T)
    fused = align_traceback_rows_packed(
        pack_nibbles_host(qb), qlens, pack_nibbles_host(tb), tlens, modes, spec, B, T
    )
    ops_list, cost, clip = expand_rows_host(fused, qb, tb, spec)
    return [_job_result(job, ops_list[i], cost[i], clip[i]) for i, job in enumerate(jobs)]


def _tier_plan(n_buckets: int, tiers: tuple[int, ...] = (16, 4, 1)) -> list[int]:
    """Greedy cover of n_buckets by the fixed K tiers (largest first), so at
    most len(tiers) programs ever compile."""
    plan: list[int] = []
    rem = n_buckets
    for K in tiers:
        while rem >= K:
            plan.append(K)
            rem -= K
    return plan


def _run_jobs_device_tb_multi(jobs: list[_Job], cfg: MapConfig, bucket: int) -> list[dict]:
    """Multi-bucket fused path: pack all jobs as [n_buckets, bucket, ...] and
    cover the bucket axis with K-tier `align_traceback_rows_multi` calls
    (K in {16, 4}, each one device call over K*bucket jobs; single buckets
    reuse the single-bucket program), so at most three programs compile."""
    from ..ops.align_device import (
        align_traceback_rows_multi_packed,
        align_traceback_rows_packed,
        expand_rows_host,
        pack_nibbles_host,
    )
    from ..utils.shapes import pull_all

    spec = cfg.spec
    B, T = spec.chunk, spec.t_width
    n = len(jobs)
    nb = -(-n // bucket)
    qb, tb, qlens, tlens, modes = (
        a.reshape(nb, bucket, *a.shape[1:]) for a in _pack_jobs(jobs, nb * bucket, B, T)
    )
    qp = pack_nibbles_host(qb)
    tp = pack_nibbles_host(tb)

    pending: list[tuple[int, int, object]] = []  # (first bucket, K, fused)
    lo = 0
    for K in _tier_plan(nb):
        sl = slice(lo, lo + K)
        if K == 1:
            fused = align_traceback_rows_packed(
                qp[lo], qlens[lo], tp[lo], tlens[lo], modes[lo], spec, B, T
            )
        else:
            fused = align_traceback_rows_multi_packed(
                qp[sl], qlens[sl], tp[sl], tlens[sl], modes[sl], spec, B, T
            )
        pending.append((lo, K, fused))
        lo += K

    host = pull_all(*(f for _, _, f in pending))
    results: list[dict] = [None] * n
    for (lo_b, K, _), fused in zip(pending, host):
        fused = np.asarray(fused)
        if K == 1:
            fused = fused[None]
        for kk in range(K):
            bi = lo_b + kk
            ops_list, cost, clip = expand_rows_host(fused[kk], qb[bi], tb[bi], spec)
            base = bi * bucket
            for i in range(min(bucket, n - base)):
                results[base + i] = _job_result(jobs[base + i], ops_list[i], cost[i], clip[i])
    return results


def map_reads(
    contigs: dict[str, str],
    read_seqs: list[str],
    cfg: MapConfig = MapConfig(),
    read_indices: list[int] | None = None,
    index: MinimizerIndex | None = None,
    restrict: list[str] | None = None,
    pinned: list[list[tuple[str, int, np.ndarray, np.ndarray]]] | None = None,
    read_codes: list[np.ndarray] | None = None,
) -> list[Alignment]:
    """Map every read against the contig set; returns accepted Alignments.

    restrict: optional per-read target contig name (parallel to read_seqs) —
    chains on other contigs are dropped. This lets many independent
    (draft, read group) polish jobs share ONE index and ONE device batch
    without cross-mapping between homologous drafts.

    pinned: optional precomputed anchor chains per read — list (parallel to
    read_seqs) of (contig_name, strand, q_anchors, t_anchors) with q in
    oriented-read coords. When given, minimizer seeding/indexing/chaining is
    skipped entirely: the anchors (typically sampled from a previous round's
    CIGARs, ops/poa.py:pin_chains) go straight to pin selection and the
    banded DP. Reads whose pinned chains produce no accepted alignment fall
    back to full seeded mapping (cfg.rescue). This is how polish remap
    rounds avoid re-seeding reads against drafts whose placements are
    already known (racon re-seeds each round; the placement is the same)."""
    contig_codes = {n: encode_seq(s) for n, s in contigs.items()}
    if index is None and pinned is None:
        # with restriction, homologous drafts share minimizers: scale the
        # repetitiveness cutoff so shared seeds survive the joint index
        occ = cfg.max_occ * (max(1, len(contigs)) if restrict is not None else 1)
        index = MinimizerIndex.build(contig_codes, k=cfg.k, w=cfg.w, max_occ=occ, hpc=cfg.hpc)
    if read_indices is None:
        read_indices = list(range(len(read_seqs)))
    restrict_by_idx = (
        dict(zip(read_indices, restrict)) if restrict is not None else None
    )

    jobs: list[_Job] = []
    # (read_i, chain, oriented_codes, job span bookkeeping)
    plans: list[dict] = []
    B = cfg.spec.chunk
    T = cfg.spec.t_width
    dr = cfg.spec.dr

    all_codes = (
        read_codes
        if read_codes is not None
        else [encode_seq(seq) for seq in read_seqs]
    )
    if pinned is not None:
        named_chains = [
            [
                (cname, strand, qa, ta)
                for cname, strand, qa, ta in read_pins
                if cname in contig_codes and qa.size >= 2
            ]
            for read_pins in pinned
        ]
    else:
        allowed_cids = None
        if restrict_by_idx is not None:
            name_to_cid = {n: i for i, n in enumerate(index.contig_names)}
            allowed_cids = [
                name_to_cid.get(restrict_by_idx[ridx], -1) for ridx in read_indices
            ]
        all_chains = find_chains_batch(
            index, all_codes, min_anchors=cfg.min_anchors, allowed_cids=allowed_cids
        )
        named_chains = [
            [
                (index.contig_names[ch.contig_id], ch.strand, ch.q_anchors, ch.t_anchors)
                for ch in read_chains
            ]
            for read_chains in all_chains
        ]
    for ridx, codes, read_chains in zip(read_indices, all_codes, named_chains):
        for cname, strand, q_anchors, t_anchors in read_chains:
            if restrict_by_idx is not None and cname != restrict_by_idx[ridx]:
                continue
            oriented = codes if strand == 1 else revcomp_codes(codes)
            tcodes = contig_codes[cname]
            pins = select_pins(q_anchors, t_anchors, cfg)
            plan = {
                "read_idx": ridx,
                "contig": cname,
                "strand": strand,
                "qlen": len(codes),
                "pins": pins,
                "jobs": [],  # (job_index, kind)
            }
            q0, t0 = pins[0]
            # left extension (reversed), pinned at the first anchor
            p_avail = q0
            p_used = min(p_avail, B)
            if p_used > 0 and t0 > 0:
                t_lo = max(0, t0 - (p_used + dr))
                jobs.append(
                    _Job(
                        q=oriented[q0 - p_used : q0][::-1].copy(),
                        t=tcodes[t_lo:t0][::-1].copy(),
                        mode=1,
                        reversed_=True,
                    )
                )
                plan["jobs"].append((len(jobs) - 1, "left", p_used))
            # global chunks between pins
            for (qa, ta), (qb2, tb2) in zip(pins[:-1], pins[1:]):
                jobs.append(
                    _Job(q=oriented[qa:qb2].copy(), t=tcodes[ta:tb2].copy(), mode=0, reversed_=False)
                )
                plan["jobs"].append((len(jobs) - 1, "mid", 0))
            # right extension from the last pin to the read end
            qe, te = pins[-1]
            s_avail = len(codes) - qe
            s_used = min(s_avail, B)
            if s_used > 0 and te < len(tcodes):
                t_hi = min(len(tcodes), te + s_used + dr)
                jobs.append(
                    _Job(q=oriented[qe : qe + s_used].copy(), t=tcodes[te:t_hi].copy(), mode=1, reversed_=False)
                )
                plan["jobs"].append((len(jobs) - 1, "right", s_used))
            plans.append(plan)

    job_results = run_jobs(jobs, cfg)

    alignments: list[Alignment] = []
    for plan in plans:
        pins = plan["pins"]
        qlen = plan["qlen"]
        q_start_o, t_start = pins[0]
        q_end_o, t_end = pins[-1]
        parts = []
        nm = 0
        for jid, kind, used in _iter_jobs(plan):
            r = job_results[jid]
            ops = r["ops"]
            nm += r["cost"]
            if kind == "left":
                # ops were reversed already; any soft clip falls off the far
                # (left) end of the walk, so consumption is just what's in ops
                cq = int(np.sum(ops != 3))  # '=','X','I' consume query
                ct = int(np.sum(ops != 2))  # '=','X','D' consume target
                q_start_o = pins[0][0] - cq
                t_start = pins[0][1] - ct
                parts.insert(0, ops)
            elif kind == "mid":
                parts.append(ops)
            else:  # right
                cq = int(np.sum(ops != 3))
                ct = int(np.sum(ops != 2))
                q_end_o = pins[-1][0] + cq
                t_end = pins[-1][1] + ct
                parts.append(ops)
        expanded = np.concatenate(parts) if parts else np.zeros(0, np.int8)
        if expanded.size == 0:
            continue
        cops, clens = compress_cigar(expanded)
        aligned_len = int(expanded.size)
        if aligned_len == 0 or nm > cfg.max_divergence * aligned_len:
            continue
        # convert oriented-read coords to forward-read coords
        if plan["strand"] == 1:
            q_start, q_end = q_start_o, q_end_o
        else:
            q_start, q_end = qlen - q_end_o, qlen - q_start_o
        alignments.append(
            Alignment(
                read_idx=plan["read_idx"],
                contig=plan["contig"],
                strand=plan["strand"],
                q_start=int(q_start),
                q_end=int(q_end),
                t_start=int(t_start),
                t_end=int(t_end),
                cigar_ops=cops,
                cigar_lens=clens,
                nm=int(nm),
            )
        )

    if pinned is not None:
        # pinned chains are a fast path, not a filter: reads whose pins
        # produced nothing get the full seeded pipeline (incl. its rescue)
        if cfg.rescue:
            mapped = {a.read_idx for a in alignments}
            unmapped = [i for i in read_indices if i not in mapped]
            if unmapped:
                by_idx = dict(zip(read_indices, read_seqs))
                alignments.extend(
                    map_reads(
                        contigs,
                        [by_idx[i] for i in unmapped],
                        cfg,
                        read_indices=unmapped,
                        restrict=(
                            [restrict_by_idx[i] for i in unmapped]
                            if restrict_by_idx is not None
                            else None
                        ),
                    )
                )
    elif cfg.rescue and (cfg.k, cfg.w) != (cfg.rescue_k, cfg.rescue_w):
        mapped = {a.read_idx for a in alignments}
        unmapped = [i for i in read_indices if i not in mapped]
        if unmapped:
            from dataclasses import replace

            rcfg = replace(cfg, k=cfg.rescue_k, w=cfg.rescue_w, rescue=False)
            by_idx = dict(zip(read_indices, read_seqs))
            alignments.extend(
                map_reads(
                    contigs,
                    [by_idx[i] for i in unmapped],
                    rcfg,
                    read_indices=unmapped,
                    restrict=(
                        [restrict_by_idx[i] for i in unmapped]
                        if restrict_by_idx is not None
                        else None
                    ),
                )
            )
    return alignments


def _iter_jobs(plan):
    # order: left first (so q_start/t_start are fixed before mids), then mids, then right
    for jid, kind, *rest in plan["jobs"]:
        used = rest[0] if rest else 0
        yield jid, kind, used
