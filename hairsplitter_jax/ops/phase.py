"""Production device phasing core, shared by the pipeline and the mesh.

This is the stage-4 device work — similarity matmuls, the knee-rule read
graph, and the seeded Chinese-Whispers runs — as ONE jittable function, so
the single-chip pipeline path (`pipeline/separate_reads.py`), the flagship
`__graft_entry__.entry()` step, and the multi-chip mesh dryrun all execute
the same code.

Rule parity with the reference (`src/separate_reads.cpp:445-530`), matching
the float32 arithmetic of the C++ (`native/hs_native.cpp:hs_create_read_graph`
is the host twin, tested bit-identical):

  dist = 1 - max(0, diff-1)/(sim+diff)           (:464-465)
  max_compat = max(5, max sim); drop rows with sim+diff < max(5, .7*max_compat)
                                                 (:461-475)
  knee threshold d0 - 3*(d0 - d1); if all-identical fallback to the 5th
  non-1.0 distance                               (:489-503)
  link if dist > 1 - 2*err and (<5 neighbors so far | dist == 1 |
  dist >= knee), symmetric                       (:505-515)
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .cluster import chinese_whispers_multi


def sims_diffs_core(A: jnp.ndarray, R: jnp.ndarray):
    """sim = 3*A*At + R*Rt, diff = A*Rt + R*At with zero diagonals
    (`src/separate_reads.cpp:399-433`); plain function for composition."""
    sim = 3.0 * (A @ A.T) + R @ R.T
    diff = A @ R.T + R @ A.T
    eye = jnp.eye(A.shape[0], dtype=jnp.float32)
    return (sim * (1 - eye)).astype(jnp.int32), (diff * (1 - eye)).astype(jnp.int32)


def read_graph_device(
    sim: jnp.ndarray,  # int32 [R, R]
    diff: jnp.ndarray,  # int32 [R, R]
    mask: jnp.ndarray,  # bool [R]
    err: jnp.ndarray,  # f32 scalar
) -> jnp.ndarray:
    """Device twin of the reference read-graph rules; returns int8 [R, R]
    symmetric adjacency, bit-identical to `native.create_read_graph`."""
    n = sim.shape[0]
    idx = jnp.arange(n, dtype=jnp.int32)
    s = sim.astype(jnp.float32)
    d = diff.astype(jnp.float32)
    valid = mask[None, :] & (idx[None, :] != idx[:, None]) & (sim > 0)
    dd = jnp.maximum(0.0, d - 1.0)
    dist = jnp.where(valid, 1.0 - dd / (s + d), 0.0)
    max_compat = jnp.max(jnp.where(valid, s, 0.0), axis=1, initial=5.0)
    # 0.7*max capped at an absolute column mass (MIN_OVERLAP_CAP in
    # pipeline/separate_reads.py — see the rationale there; must stay in
    # sync with the host and native twins for bit-identity)
    floor_compat = jnp.maximum(
        5.0, jnp.minimum(jnp.float32(0.7) * max_compat, jnp.float32(18.0))
    )
    dist = jnp.where(valid & ((s + d) < floor_compat[:, None]), 0.0, dist)

    order = jnp.argsort(-dist, axis=1, stable=True)
    dsorted = jnp.take_along_axis(dist, order, axis=1)
    link_thr = (
        dsorted[:, 0] - (dsorted[:, 0] - dsorted[:, 1]) * 3.0
        if n > 1
        else jnp.ones((n,), jnp.float32)
    )
    k = jnp.sum(dsorted == 1.0, axis=1)
    k2 = jnp.minimum(k + 4, n - 1)
    fb = jnp.take_along_axis(dsorted, k2[:, None], axis=1)[:, 0]
    link_thr = jnp.where((link_thr == 1.0) & (k < n), fb, link_thr)

    d_floor = jnp.minimum(1.0 - 2.0 * err, jnp.float32(0.99))
    uncond = (dsorted == 1.0) | (dsorted >= link_thr[:, None])
    mask_j = jnp.take_along_axis(jnp.broadcast_to(mask[None, :], (n, n)), order, axis=1)
    base_ok = (dsorted > d_floor) & mask_j

    def step(nb, xs):
        ok_r, unc_r = xs
        accept = ok_r & (unc_r | (nb < 5))
        return nb + accept.astype(jnp.int32), accept

    _, accepts = jax.lax.scan(step, jnp.zeros((n,), jnp.int32), (base_ok.T, uncond.T))
    accepts = accepts.T  # [R, n] in rank order
    adj_dir = jnp.zeros((n, n), bool).at[idx[:, None], order].set(accepts)
    adj_dir = adj_dir & mask[:, None]  # only masked rows propose links
    return (adj_dir | adj_dir.T).astype(jnp.int8)


def phase_window_core(
    sim: jnp.ndarray,  # int32 [R, R] (contig-level, from sims_diffs)
    diff: jnp.ndarray,
    mask: jnp.ndarray,  # bool [R] window span mask
    inits: jnp.ndarray,  # int32 [K, R] per-SNP seed labelings
    err: jnp.ndarray,  # f32 scalar global error rate
    n_iters: int = 30,
):
    """One window's device phasing: read graph + all seeded CW runs.
    Returns (adj int8 [R, R], labels int32 [K, R])."""
    adj = read_graph_device(sim, diff, mask, err)
    labels = chinese_whispers_multi(adj.astype(jnp.float32), inits, mask, n_iters=n_iters)
    return adj, labels


@partial(jax.jit, static_argnames=("n_iters",))
def phase_window_jit(sim, diff, mask, inits, err, n_iters: int = 30):
    return phase_window_core(sim, diff, mask, inits, err, n_iters)


@partial(jax.jit, static_argnames=("n_iters",))
def phase_windows_sub_jit(sims, diffs, masks, inits, err, n_iters: int = 30):
    """Row-compacted window batch: each window carries only the reads that
    span it (sims/diffs [W, r, r] gathered per window on host), so the CW
    vote matmuls are r x r instead of R x R. At long-read coverage r is
    ~1-3% of a 300 kb contig's read count — the dense full-matrix batch was
    paying the squared difference."""
    return jax.vmap(
        lambda s, d, m, i: phase_window_core(s, d, m, i, err, n_iters)
    )(sims, diffs, masks, inits)


@partial(jax.jit, static_argnames=("n_iters",))
def phase_windows_jit(sim, diff, masks, inits, err, n_iters: int = 30):
    """Every window of one contig in ONE device call: `sim`/`diff` are
    contig-level (window-independent, shared across the vmap), only the span
    masks [Wn, R] and seed labelings [Wn, K, R] vary per window. One call +
    one pull replaces a call per window: one big batch pays one dispatch
    and one sync instead of one per window."""
    return jax.vmap(
        lambda m, i: phase_window_core(sim, diff, m, i, err, n_iters)
    )(masks, inits)


def phase_contigs_batch(
    pileup: jnp.ndarray,  # int8 [C, R, P] trimer codes (TRIMER_ABSENT = none)
    contig_codes: jnp.ndarray,  # int8 [C, P]
    A: jnp.ndarray,  # f32 [C, R, S] second-allele indicators
    Rm: jnp.ndarray,  # f32 [C, R, S] majority-allele indicators
    mask: jnp.ndarray,  # bool [C, R]
    inits: jnp.ndarray,  # int32 [C, K, R]
    n_iters: int = 30,
):
    """The full stage-3/4 device step over a batch of contig windows: the
    global error-rate reduction (the reference's omp-critical sum,
    `src/call_variants.cpp:1310-1316` — an all-reduce under sharding),
    contig-level sims/diffs matmuls, and the per-window graph + CW.  This is
    the function the driver's multi-chip dryrun shards, built from the same
    `window_error_stats` / `phase_window_core` the pipeline runs."""
    from .variants import window_error_stats

    mism, cov = jax.vmap(window_error_stats)(pileup, contig_codes)
    err = jnp.sum(mism).astype(jnp.float32) / jnp.maximum(
        jnp.sum(cov).astype(jnp.float32), 1.0
    )
    sim, diff = jax.vmap(sims_diffs_core)(A, Rm)
    adj, labels = jax.vmap(
        lambda s, d, m, i: phase_window_core(s, d, m, i, err, n_iters)
    )(sim, diff, mask, inits)
    return err, adj, labels
