"""Static-shape bucketing for device calls.

Everything under jit is compiled per shape; ragged inputs (reads per window,
SNPs per contig, seeds per window) would otherwise trigger one XLA compile
per distinct size - seconds each - and defeat the compile cache.
Pad every device-call operand up to a power-of-two bucket and slice the
result back; the ops are written so padding is a no-op (absent trimer code,
zero indicator rows, masked-out graph nodes).
"""

from __future__ import annotations

import numpy as np


def pow2_bucket(n: int, minimum: int = 32) -> int:
    """Smallest power of two >= n (and >= minimum)."""
    n = max(int(n), 1)
    return max(minimum, 1 << (n - 1).bit_length())


_pull_pool = None


def pull_all(*arrs) -> list[np.ndarray]:
    """Materialize several device arrays concurrently: issuing the
    device->host pulls from a thread pool overlaps the transfers. The pool
    is module-level so hot paths with many small multi-buffer pulls don't
    pay thread spawn/teardown per call."""
    if len(arrs) <= 1:
        return [np.asarray(a) for a in arrs]
    global _pull_pool
    if _pull_pool is None:
        from concurrent.futures import ThreadPoolExecutor

        _pull_pool = ThreadPoolExecutor(max_workers=8, thread_name_prefix="hs-pull")
    return list(_pull_pool.map(np.asarray, arrs))


def pad_axis(arr: np.ndarray, axis: int, size: int, fill) -> np.ndarray:
    """Pad `arr` with `fill` along `axis` up to `size` (no-op if already)."""
    if arr.shape[axis] >= size:
        return arr
    widths = [(0, 0)] * arr.ndim
    widths[axis] = (0, size - arr.shape[axis])
    return np.pad(arr, widths, constant_values=fill)
