"""Batched banded edit-distance alignment (the framework's DP workhorse).

Replaces the reference's edlib Myers bit-vector kernel (`src/edlib/`, used for
flank trimming `src/create_new_contigs.cpp:556-629` and racon-end reattachment
`src/tools.cpp:515-534`) and minimap2's base-level alignment with a
vectorised formulation:

  * the DP runs over a fixed diagonal band of width W (one vector per row),
  * each query row is one vector step; the intra-row horizontal dependency
    ('D' runs) is solved exactly with a prefix-min (``lax.cummin``) instead of a
    sequential inner loop,
  * N chunk alignments are batched on the leading axis; `lax.scan` iterates
    rows, so the whole batch is one fused XLA program,
  * 2-bit backpointers stream out per row; traceback is a cheap vectorized
    lockstep walk on host.

Two modes per chunk:
  mode 0 (global): align q[0:qlen] to t[0:tlen] end-to-end (both pinned),
  mode 1 (extension): start pinned at (0,0), free target end — used to extend
    from the last anchor to the read end; if the target runs out first the
    remaining query is soft-clipped.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

INF = np.int32(1 << 20)
Q_SENTINEL = 7  # query padding code (never equals target)
T_SENTINEL = 6  # target padding code

# expanded traceback op codes (match io.cigar OPS order '=XIDMSH')
TB_EQ, TB_X, TB_I, TB_D = 0, 1, 2, 3
# backpointer codes stored by the DP kernel
BP_DIAG, BP_UP, BP_LEFT = 0, 1, 2


@dataclass(frozen=True)
class BandSpec:
    """Geometry of the banded DP.

    chunk: max query length B per chunk; band: band width W (lane-aligned).
    The band covers target offsets j - i in [-dl, dr]."""

    chunk: int = 256
    band: int = 128

    @property
    def dl(self) -> int:
        return self.band // 2

    @property
    def dr(self) -> int:
        return self.band - 1 - self.band // 2

    @property
    def t_width(self) -> int:
        # target buffer width: j ranges up to qlen + dr <= chunk + dr
        return self.chunk + self.dr


@partial(jax.jit, static_argnames=("spec",))
def banded_align_batch(
    q: jnp.ndarray,  # int8 [N, B] query codes, padded with Q_SENTINEL
    q_lens: jnp.ndarray,  # int32 [N]
    t: jnp.ndarray,  # int8 [N, T] target codes, padded with T_SENTINEL
    t_lens: jnp.ndarray,  # int32 [N]
    spec: BandSpec = BandSpec(),
):
    """Run the banded DP on a batch of chunks.

    Returns dict with
      bp:        uint8 [N, B, W] backpointers for rows 1..B (0 diag, 1 up/I, 2 left/D)
      row_at_q:  int32 [N, W] the DP row at i == qlen (per chunk)
      colmin_val/colmin_i: best cell in the j == tlen column and its row —
                 used for soft-clipping when the target is exhausted.
    """
    N, B = q.shape
    W = spec.band
    dl = spec.dl
    q_lens = q_lens.astype(jnp.int32)
    t_lens = t_lens.astype(jnp.int32)

    # pad target: dl sentinels at the left so row i reads t_padded[:, (i-1)+b]
    pad_right = B + W - t.shape[1]
    t_padded = jnp.pad(t, ((0, 0), (dl, max(0, pad_right))), constant_values=T_SENTINEL)

    barange = jnp.arange(W, dtype=jnp.int32)

    # row 0: M[0][j] = j (leading deletions), j = b - dl
    j0 = barange - dl
    row0 = jnp.where((j0 >= 0) & (j0[None, :] <= t_lens[:, None]), j0[None, :], INF)
    row0 = jnp.broadcast_to(row0, (N, W)).astype(jnp.int32)

    def step(carry, i):
        prev, row_at_q, colmin_val, colmin_i = carry
        qc = jax.lax.dynamic_slice_in_dim(q, i - 1, 1, axis=1)  # [N,1]
        tw = jax.lax.dynamic_slice_in_dim(t_padded, i - 1, W, axis=1)  # [N,W]
        sub = jnp.where(qc == tw, 0, 1).astype(jnp.int32)
        diag = prev + sub
        up = jnp.concatenate([prev[:, 1:], jnp.full((N, 1), INF, jnp.int32)], axis=1) + 1
        tmp = jnp.minimum(diag, up)
        # exact horizontal ('D'-run) resolution: prefix-min along the band
        row = jax.lax.cummin(tmp - barange[None, :], axis=1) + barange[None, :]
        # mask cells outside [0, tlen] (j = i + b - dl)
        j = i + barange[None, :] - dl
        valid = (j >= 0) & (j <= t_lens[:, None]) & (i <= q_lens[:, None] + 0 * j)
        row = jnp.where(valid, jnp.minimum(row, INF), INF)
        op = jnp.where(row == diag, BP_DIAG, jnp.where(row == up, BP_UP, BP_LEFT)).astype(jnp.uint8)

        row_at_q = jnp.where((i == q_lens)[:, None], row, row_at_q)
        # track best cell in the j == tlen column (for target-exhausted soft clips)
        b_col = t_lens - i + dl
        colv = jnp.take_along_axis(row, jnp.clip(b_col, 0, W - 1)[:, None], axis=1)[:, 0]
        colv = jnp.where((b_col >= 0) & (b_col < W) & (i <= q_lens), colv, INF)
        better = colv < colmin_val
        colmin_val = jnp.where(better, colv, colmin_val)
        colmin_i = jnp.where(better, i, colmin_i)
        return (row, row_at_q, colmin_val, colmin_i), op

    init = (
        row0,
        jnp.where((q_lens == 0)[:, None], row0, INF),
        jnp.full((N,), INF, jnp.int32),
        jnp.zeros((N,), jnp.int32),
    )
    (_, row_at_q, colmin_val, colmin_i), bp = jax.lax.scan(
        step, init, jnp.arange(1, B + 1, dtype=jnp.int32)
    )
    return {
        "bp": jnp.transpose(bp, (1, 0, 2)),  # [N, B, W]
        "row_at_q": row_at_q,
        "colmin_val": colmin_val,
        "colmin_i": colmin_i,
    }


def readout(
    res: dict,
    q_lens: np.ndarray,
    t_lens: np.ndarray,
    modes: np.ndarray,
    spec: BandSpec,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Choose per-chunk end cell. Returns (cost, start_i, start_b, clip_len).

    clip_len > 0 means the last clip_len query bases are soft-clipped
    (extension mode only, when the target was exhausted first)."""
    row_at_q = np.asarray(res["row_at_q"])
    colmin_val = np.asarray(res["colmin_val"])
    colmin_i = np.asarray(res["colmin_i"])
    N, W = row_at_q.shape
    dl = spec.dl
    barange = np.arange(W)
    j = q_lens[:, None] + barange[None, :] - dl
    # global: corner cell j == tlen
    b_corner = t_lens - q_lens + dl
    corner = np.take_along_axis(row_at_q, np.clip(b_corner, 0, W - 1)[:, None], axis=1)[:, 0]
    corner = np.where((b_corner >= 0) & (b_corner < W), corner, INF)
    # extension: best cell in the final row (free target end)
    masked = np.where((j >= 0) & (j <= t_lens[:, None]), row_at_q, INF)
    b_row = masked.argmin(axis=1)
    rowbest = masked[np.arange(N), b_row]

    is_ext = modes == 1
    use_col = is_ext & (colmin_val < rowbest)
    cost = np.where(is_ext, np.minimum(rowbest, colmin_val), corner)
    start_i = np.where(use_col, colmin_i, q_lens)
    start_b = np.where(
        use_col, t_lens - colmin_i + dl, np.where(is_ext, b_row, b_corner)
    )
    clip = np.where(use_col, q_lens - colmin_i, 0)
    # unreachable end cell (e.g. global corner outside the band): emit an
    # empty walk — a start at (0, dl) is immediately inactive. The mapper
    # drops these alignments anyway (nm >= INF fails the divergence filter)
    dead = cost >= INF
    start_i = np.where(dead, 0, start_i)
    start_b = np.where(dead, dl, start_b)
    clip = np.where(dead, 0, clip)
    return cost.astype(np.int64), start_i.astype(np.int64), start_b.astype(np.int64), clip.astype(np.int64)


def traceback_batch(
    bp: np.ndarray,  # uint8 [N, B, W]
    q: np.ndarray,  # int8 [N, B]
    t: np.ndarray,  # int8 [N, T]
    start_i: np.ndarray,
    start_b: np.ndarray,
    spec: BandSpec,
) -> list[np.ndarray]:
    """Vectorized lockstep traceback. Returns per-chunk expanded op arrays
    (values TB_EQ/TB_X/TB_I/TB_D, in alignment order)."""
    bp = np.asarray(bp)
    N, B, W = bp.shape
    dl = spec.dl
    max_steps = B + spec.t_width + 1
    out = np.full((N, max_steps), -1, dtype=np.int8)
    i = start_i.astype(np.int64).copy()
    b = start_b.astype(np.int64).copy()
    n_idx = np.arange(N)
    for step in range(max_steps):
        jcol = i + b - dl
        active = (i > 0) | (jcol > 0)
        if not active.any():
            break
        at_top = active & (i == 0)  # only leading deletions remain
        inner = active & ~at_top
        opv = np.zeros(N, dtype=np.int8)
        opv[at_top] = TB_D
        bi = np.clip(i - 1, 0, B - 1)
        bpv = bp[n_idx, bi, np.clip(b, 0, W - 1)]
        # diag: compare chars to emit '=' or 'X'
        qi = np.clip(i - 1, 0, B - 1)
        tj = np.clip(jcol - 1, 0, t.shape[1] - 1)
        same = q[n_idx, qi] == t[n_idx, tj]
        diag_op = np.where(same, TB_EQ, TB_X).astype(np.int8)
        opv[inner] = np.where(
            bpv == BP_DIAG, diag_op, np.where(bpv == BP_UP, TB_I, TB_D)
        )[inner]
        out[active, step] = opv[active]
        # state update
        move_diag = inner & (bpv == BP_DIAG)
        move_up = inner & (bpv == BP_UP)
        move_left = (inner & (bpv == BP_LEFT)) | at_top
        i = i - move_diag - move_up
        b = b + move_up - move_left
    # reverse and strip
    results = []
    for nth in range(N):
        ops = out[nth][out[nth] >= 0][::-1]
        results.append(ops)
    return results
