"""Device ops for read separation: similarity matmuls + label propagation.

The reference's own matrix formulation maps straight onto the MXU:
sim = 3·A·Aᵀ + R·Rᵀ, diff = A·Rᵀ + R·Aᵀ over read×SNP allele indicators
(`src/separate_reads.cpp:374-433`, Eigen sparse products there), and Chinese
Whispers label propagation re-expressed as a dense adjacency × one-hot-label
matmul with synchronous parity-alternating updates (the reference iterates
nodes in random order, `src/cluster_graph.cpp:152-230`; parity alternation
gives the same fixpoints deterministically and without 2-cycles).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


@jax.jit
def sims_diffs_packed(Ap: jnp.ndarray, Rp: jnp.ndarray):
    """`sims_diffs` taking BIT-PACKED indicators (uint8 [n_reads, n_snps/8],
    little-endian): the SNP axis unpacks on device, so the host ships 1 bit
    per cell instead of an f32 — 32x less transfer, same int32 results."""
    bits = jnp.arange(8, dtype=jnp.uint8)[None, None, :]
    A = ((Ap[:, :, None] >> bits) & jnp.uint8(1)).reshape(Ap.shape[0], -1).astype(jnp.float32)
    R = ((Rp[:, :, None] >> bits) & jnp.uint8(1)).reshape(Rp.shape[0], -1).astype(jnp.float32)
    return sims_diffs(A, R)


@partial(jax.jit, static_argnames=("out_rows",))
def sims_diffs_packed_pull(Ap: jnp.ndarray, Rp: jnp.ndarray, out_rows: int):
    """`sims_diffs_packed` + transfer shaping: slice the result to the
    `out_rows` x `out_rows` corner actually used (inputs are padded to a
    power-of-two bucket for compile-shape stability) and stack sim/diff into
    ONE int16 tensor, so the host pays a single pull of 2*out_rows^2 int16
    instead of two full-bucket int32 pulls. Only valid when
    3 * n_snps < 32767 (the max sim entry is 3x the shared column count)."""
    sim, diff = sims_diffs_packed(Ap, Rp)
    return jnp.stack(
        [sim[:out_rows, :out_rows], diff[:out_rows, :out_rows]]
    ).astype(jnp.int16)


@jax.jit
def sims_diffs(A: jnp.ndarray, R: jnp.ndarray):
    """Similarity / difference matrices from allele indicators.

    A, R: float32 [n_reads, n_snps]; 1.0 where the read carries the second /
    majority allele. Returns (sim, diff) int32 [n_reads, n_reads] with zeroed
    diagonals (`src/separate_reads.cpp:399-433`)."""
    sim = 3.0 * (A @ A.T) + R @ R.T
    diff = A @ R.T + R @ A.T
    eye = jnp.eye(A.shape[0], dtype=jnp.float32)
    sim = sim * (1 - eye)
    diff = diff * (1 - eye)
    return sim.astype(jnp.int32), diff.astype(jnp.int32)


@partial(jax.jit, static_argnames=("n_iters",))
def chinese_whispers_matmul(
    adj: jnp.ndarray,  # float32 [R, R], nonzero = edge (weights ignored, as in CW)
    init: jnp.ndarray,  # int32 [R] initial labels in [0, R)
    mask: jnp.ndarray,  # bool [R] — False nodes keep label -2
    n_iters: int = 30,  # half-sweeps; ~15 full sweeps like the reference
):
    """Deterministic Chinese Whispers by masked matmul label propagation.

    Each half-sweep updates nodes of one index parity to the label most
    frequent among their neighbors (+1 per neighbor, unweighted — matching
    `src/cluster_graph.cpp:240-310`); ties break by a deterministic
    per-(node,label) hash jitter so no label systematically invades.
    Stops early when a full sweep changes <3 labels (reference stop rule)."""
    Rn = adj.shape[0]
    # all nodes vote (the reference lets unmasked nodes vote with their fixed
    # labels; only masked nodes update)
    edge = (adj > 0).astype(jnp.float32)
    parity = jnp.arange(Rn, dtype=jnp.int32) % 2
    labels0 = jnp.where(mask, init, -2).astype(jnp.int32)
    # tie-break jitter in (0, 0.5): pseudo-random, fixed for the whole run
    ij = jnp.arange(Rn, dtype=jnp.uint32)
    h = (
        ij[:, None] * jnp.uint32(2654435761)
        + ij[None, :] * jnp.uint32(40503)
        + jnp.uint32(12345)
    ) & jnp.uint32(0xFFFF)
    jitter = h.astype(jnp.float32) / (2.0 * 65536.0)

    def half_sweep(state):
        labels, it, changes = state
        onehot = jax.nn.one_hot(jnp.where(labels >= 0, labels, 0), Rn, dtype=jnp.float32)
        onehot = onehot * (labels >= 0)[:, None]
        scores = edge @ onehot + jitter  # [R, R] votes per label + tie jitter
        best = jnp.argmax(scores, axis=1).astype(jnp.int32)
        best_val = jnp.max(scores - jitter, axis=1)
        upd = mask & (best_val > 0) & (parity == (it % 2))
        new_labels = jnp.where(upd, best, labels)
        changes = changes + jnp.sum(new_labels != labels)
        return new_labels, it + 1, changes

    def cond(state):
        _, it, changes = state
        # run at least 2 half-sweeps; stop when a full sweep changed < 3
        full_sweeps_done = it // 2
        return (it < n_iters) & ((it < 4) | (changes >= 3 * full_sweeps_done // 2))

    labels, _, _ = jax.lax.while_loop(cond, half_sweep, (labels0, jnp.int32(0), jnp.int32(0)))
    return labels


@partial(jax.jit, static_argnames=("n_iters",))
def chinese_whispers_multi(
    adj: jnp.ndarray,  # float32 [R, R]
    inits: jnp.ndarray,  # int32 [K, R] — one label propagation per seed
    mask: jnp.ndarray,  # bool [R]
    n_iters: int = 30,
):
    """All per-SNP-seeded CW runs of one window as a single device call.
    This is the batched MXU path for the reference's per-SNP clustering loop
    (`src/separate_reads.cpp:1674-1705`). Seeds run under `lax.map` rather
    than vmap: each CW sweep holds an [R, R] vote matrix, so a vmapped seed
    axis multiplies activation memory by K (and by the window count when the
    caller vmaps over windows) — sequential seeds keep memory at one vote
    matrix per window while outer window batching supplies the
    parallelism."""
    return jax.lax.map(
        lambda init: chinese_whispers_matmul(adj, init, mask, n_iters=n_iters), inits
    )


def cw_numpy(
    adj: np.ndarray, init: np.ndarray, mask: np.ndarray, n_iters: int = 15, seed: int = 0
) -> np.ndarray:
    """Host implementation: asynchronous, seeded-random node order and random
    tie-breaks, exactly the reference's scheme (`src/cluster_graph.cpp:240-310`)
    but reproducible (the reference seeds from std::random_device). A
    deterministic index order would let one label systematically invade
    neighboring clusters through single weak cross-edges."""
    rng = np.random.default_rng(seed)
    labels = np.where(mask, init, -2).astype(np.int64)
    nz = [np.nonzero(adj[i])[0] for i in range(adj.shape[0])]
    order = np.arange(adj.shape[0])
    for _ in range(n_iters):
        changes = 0
        rng.shuffle(order)
        for i in order:
            if not mask[i]:
                continue
            neigh = nz[i]
            if neigh.size == 0:
                continue
            lab = labels[neigh]
            lab = lab[lab >= 0]
            if lab.size == 0:
                continue
            counts = np.bincount(lab)
            top = np.nonzero(counts == counts.max())[0]
            best = int(top[rng.integers(top.size)]) if top.size > 1 else int(top[0])
            if counts[best] > 0 and labels[i] != best:
                labels[i] = best
                changes += 1
        if changes < 3:
            break
    return labels
