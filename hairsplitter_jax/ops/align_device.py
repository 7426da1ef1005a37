"""Device-side readout + traceback for the banded DP.

The end-cell selection (`ops.align.readout`) and the lockstep traceback walk
(`ops.align.traceback_batch`) run on device as vector ops / one `lax.scan`,
so a chunk alignment ships home as ~0.3 KB of per-row traceback tokens
instead of 8 KB of backpointers. Outputs are bit-identical to the host pair
(tested).

This is the stage-2 speed path replacing minimap2's base-level alignment
(`hairsplitter.py:629-630`) and edlib's traceback (`src/edlib/`).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .align import BandSpec, BP_LEFT, BP_UP, INF, banded_align_batch


def readout_device(res: dict, q_lens, t_lens, modes, spec: BandSpec):
    """jnp twin of `ops.align.readout` (same masked formulas)."""
    row_at_q = res["row_at_q"]
    colmin_val = res["colmin_val"]
    colmin_i = res["colmin_i"]
    N, W = row_at_q.shape
    dl = spec.dl
    q_lens = q_lens.astype(jnp.int32)
    t_lens = t_lens.astype(jnp.int32)
    bar = jnp.arange(W, dtype=jnp.int32)[None, :]
    j = q_lens[:, None] + bar - dl
    b_corner = t_lens - q_lens + dl
    corner = jnp.take_along_axis(row_at_q, jnp.clip(b_corner, 0, W - 1)[:, None], axis=1)[:, 0]
    corner = jnp.where((b_corner >= 0) & (b_corner < W), corner, INF)
    masked = jnp.where((j >= 0) & (j <= t_lens[:, None]), row_at_q, INF)
    b_row = jnp.argmin(masked, axis=1).astype(jnp.int32)
    rowbest = jnp.take_along_axis(masked, b_row[:, None], axis=1)[:, 0]

    is_ext = modes == 1
    use_col = is_ext & (colmin_val < rowbest)
    cost = jnp.where(is_ext, jnp.minimum(rowbest, colmin_val), corner)
    start_i = jnp.where(use_col, colmin_i, q_lens)
    start_b = jnp.where(use_col, t_lens - colmin_i + dl, jnp.where(is_ext, b_row, b_corner))
    clip = jnp.where(use_col, q_lens - colmin_i, 0)
    # unreachable end cell: empty walk (matches ops.align.readout)
    dead = cost >= INF
    start_i = jnp.where(dead, 0, start_i)
    start_b = jnp.where(dead, dl, start_b)
    clip = jnp.where(dead, 0, clip)
    return cost, start_i, start_b, clip


def traceback_rows_device(bp, start_i, start_b, spec: BandSpec):
    """Row-lockstep traceback: one scan step per QUERY ROW instead of one per
    emitted op.

    A per-op lockstep walk costs B + t_width + 1 sequential steps, each
    gathering one byte per alignment from the [N, B*W] backpointer plane.
    Key observation: LEFT moves (deletions) are the only moves that do not
    consume a query row, and within a row they form one contiguous run
    ending at the first non-LEFT cell at-or-below the current band
    position. Compressing each run with a per-row prefix
    max (`encode_runs`) makes every step consume exactly one row, so step k
    processes row B-k for EVERY active alignment - the plane is indexed
    statically (scan xs), and the only cross-lane op is a W-lane masked
    reduction. B + t_width + 1 gather-steps become B tiny vector steps.

    Returns uint8 [N, B] row tokens `d | (up << 7)` (row r at column r-1):
    walking backwards through row r emits `d` deletions and then one
    diagonal (up=0) or insertion (up=1) op. d <= W-1 < 128 always (band
    positions are [0, W)), so 7 bits suffice. Rows above the start cell
    emit 0. The host expansion (`expand_rows_host`) reconstructs the band
    positions from the tokens alone - matching `traceback_batch` bit for
    bit - and resolves '=' vs 'X' itself (it holds q and t), so no per-op
    stream ever crosses the device link."""
    enc = encode_runs(bp)
    N, B, W = enc.shape
    lane = jax.lax.broadcasted_iota(jnp.int32, (1, W), 1)
    si = start_i.astype(jnp.int32)

    def step(b, xs):
        run_row, r = xs
        active = r <= si
        v = jnp.sum(jnp.where(lane == b[:, None], run_row.astype(jnp.int32), 0), axis=1)
        nl = jnp.maximum((v >> 1) - 1, 0)  # non-LEFT cell the run ends at
        up = v & 1
        d = jnp.maximum(b - nl, 0)
        token = jnp.where(active, d | (up << 7), 0).astype(jnp.uint8)
        b2 = jnp.where(active, nl + up, b)
        return b2, token

    rows = jnp.arange(1, B + 1, dtype=jnp.int32)
    _, toks = jax.lax.scan(
        step, start_b.astype(jnp.int32), (jnp.transpose(enc, (1, 0, 2)), rows),
        reverse=True, unroll=8,
    )
    return toks.T  # [N, B]


def encode_runs(bp):
    """Encode (position+1, is_up) of every non-LEFT cell; a prefix max along
    the band finds, for every cell, the non-LEFT cell its LEFT-run ends at.
    Log2(W) doubling passes over the whole plane (lax.cummax inside a scan
    step lowers to an O(W^2) reduce-window per step)."""
    N, B, W = bp.shape
    lane = jax.lax.broadcasted_iota(jnp.int32, (1, 1, W), 2)
    enc = jnp.where(
        bp != BP_LEFT,
        (((lane + 1) << 1) | (bp == BP_UP)).astype(jnp.int16),
        jnp.int16(0),
    )
    k = 1
    while k < W:
        shifted = jnp.concatenate(
            [jnp.zeros((N, B, k), jnp.int16), enc[:, :, : W - k]], axis=2
        )
        enc = jnp.maximum(enc, shifted)
        k *= 2
    return enc


@partial(jax.jit, static_argnames=("spec",))
def align_traceback_rows(q, q_lens, t, t_lens, modes, spec: BandSpec):
    """One device call per batch: the banded DP (`ops.align.
    banded_align_batch`) + readout + row-lockstep traceback.

    Returns fused uint8 [N, 16 + B]: int32 meta (cost, clip, start_i,
    start_b) followed by the per-row traceback tokens. Decode with
    `expand_rows_host` - outputs equal the host readout+traceback_batch
    pair element for element."""
    return _align_traceback_rows_impl(q, q_lens, t, t_lens, modes, spec)


@partial(jax.jit, static_argnames=("spec",))
def align_traceback_rows_multi(q, q_lens, t, t_lens, modes, spec: BandSpec):
    """K buckets in ONE device call. Inputs carry a leading K axis; the
    buckets' jobs are independent, so they are flattened into one [K*N]
    batch and the result is split back into uint8 [K, N, 16 + B]."""
    K, N = q.shape[:2]
    flat = lambda x: x.reshape(K * N, *x.shape[2:])  # noqa: E731
    fused = _align_traceback_rows_impl(
        flat(q), flat(q_lens), flat(t), flat(t_lens), flat(modes), spec
    )
    return fused.reshape(K, N, -1)


def pack_nibbles_host(arr):
    """Host side: int8 [..., L] codes (all < 16) -> uint8 [..., ceil(L/2)],
    two codes per byte (low nibble = even column); odd L pads one zero
    column that `_unpack_nibbles` truncates away. int8 -> uint8 is a
    zero-copy view; the odd-width case copies into a preallocated buffer
    instead of np.pad (both copies showed up in the mapping profile)."""
    import numpy as np

    a = np.asarray(arr)
    a = a.view(np.uint8) if a.dtype == np.int8 else a.astype(np.uint8)
    if a.shape[-1] % 2:
        b = np.zeros(a.shape[:-1] + (a.shape[-1] + 1,), dtype=np.uint8)
        b[..., :-1] = a
        a = b
    return (a[..., 0::2] & 0xF) | (a[..., 1::2] << 4)


def _unpack_nibbles(x, L):
    """Device inverse of `pack_nibbles_host` -> int8 [N, L]. Lossless for
    codes 0..15, which covers bases 0..3, GAP 4, PAD 5 and both sentinels
    (6/7) — so the packed upload is bit-identical to the int8 one."""
    lo = (x & jnp.uint8(0xF)).astype(jnp.int8)
    hi = (x >> jnp.uint8(4)).astype(jnp.int8)
    return jnp.stack([lo, hi], axis=-1).reshape(*x.shape[:-1], x.shape[-1] * 2)[..., :L]


@partial(jax.jit, static_argnames=("spec", "B", "T"))
def align_traceback_rows_packed(qp, q_lens, tp, t_lens, modes, spec: BandSpec, B: int, T: int):
    """`align_traceback_rows` taking nibble-packed q/t uploads (2 codes per
    byte): the job upload is ~2.3x the fused download, so packing halves
    the larger half of the host<->device traffic."""
    return _align_traceback_rows_impl(
        _unpack_nibbles(qp, B), q_lens, _unpack_nibbles(tp, T), t_lens, modes, spec
    )


@partial(jax.jit, static_argnames=("spec", "B", "T"))
def align_traceback_rows_multi_packed(qp, q_lens, tp, t_lens, modes, spec: BandSpec, B: int, T: int):
    """K nibble-packed buckets in one call (see align_traceback_rows_multi)."""
    return align_traceback_rows_multi(
        _unpack_nibbles(qp, B), q_lens, _unpack_nibbles(tp, T), t_lens, modes, spec
    )


def _align_traceback_rows_impl(q, q_lens, t, t_lens, modes, spec: BandSpec):
    res = banded_align_batch(q, q_lens, t, t_lens, spec)
    cost, start_i, start_b, clip = readout_device(
        res, q_lens, t_lens, modes.astype(jnp.int32), spec
    )
    toks = traceback_rows_device(res["bp"], start_i, start_b, spec)
    meta = jnp.stack(
        [cost.astype(jnp.int32), clip.astype(jnp.int32), start_i.astype(jnp.int32), start_b.astype(jnp.int32)],
        axis=1,
    )
    return jnp.concatenate([meta.view(jnp.uint8).reshape(meta.shape[0], 16), toks], axis=1)


def expand_rows_host(fused, qb, tb, spec: BandSpec):
    """Host decode of `align_traceback_rows`: rebuild the full expanded op
    streams (forward order) from the per-row (d, up) tokens.

    The band-position sequence is recovered from the tokens alone
    (b_{r-1} = b_r - d_r + up_r), then '='/'X' is decided by comparing q/t
    directly — dispatched to the native C++ twin when available (one pass,
    no temporaries), else vectorised numpy. Returns (ops_list, cost, clip)."""
    import numpy as np

    from .align import TB_D, TB_EQ, TB_I, TB_X

    fused = np.asarray(fused)
    meta = fused[:, :16].copy().view(np.int32)  # cost, clip, start_i, start_b
    toks = fused[:, 16:]
    N, B = toks.shape

    from .. import native as _native

    nat = _native.expand_rows(toks, meta, qb, tb, spec.dl)
    if nat is not None:
        flat, offsets = nat
        ops_list = [flat[offsets[i] : offsets[i + 1]] for i in range(N)]
        return ops_list, meta[:, 0], meta[:, 1]
    dl = spec.dl
    start_i = meta[:, 2].astype(np.int64)
    start_b = meta[:, 3].astype(np.int64)
    d = (toks & 0x7F).astype(np.int64)
    up = (toks >> 7).astype(np.int64)
    rows = np.arange(1, B + 1, dtype=np.int64)[None, :]
    active = rows <= start_i[:, None]
    d *= active
    up *= active
    # band position on arrival at row r: b_{r-1} = b_r - d_r + up_r
    move = d - up
    cums = np.cumsum(move, axis=1)
    b_r = start_b[:, None] - (cums[:, -1:] - cums)
    nl = b_r - d
    b0 = np.where(start_i > 0, nl[:, 0] + up[:, 0], start_b)
    jf = np.maximum(b0 - dl, 0)  # leading deletions once the query is spent
    jcol = rows + nl - dl
    tj = np.take_along_axis(tb, np.clip(jcol - 1, 0, tb.shape[1] - 1).astype(np.int64), axis=1)
    same = qb[:, :B] == tj
    opv = np.where(up == 1, TB_I, np.where(same, TB_EQ, TB_X)).astype(np.int8)
    # interleave (counts, values): [D x jf, op_1, D x d_1, op_2, D x d_2, ...]
    V = np.empty((N, 2 * B + 1), np.int8)
    C = np.empty((N, 2 * B + 1), np.int64)
    V[:, 0] = TB_D
    C[:, 0] = jf
    V[:, 1::2] = opv
    C[:, 1::2] = active
    V[:, 2::2] = TB_D
    C[:, 2::2] = d
    flat = np.repeat(V.ravel(), C.ravel())
    totals = C.sum(axis=1)
    ops_list = np.split(flat, np.cumsum(totals)[:-1])
    return ops_list, meta[:, 0], meta[:, 1]

