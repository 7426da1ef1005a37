"""Multi-bucket fused dispatch + nibble-packed uploads (round-5 perf wave).

`core/mapping.py:_run_jobs_device_tb_multi` covers large runs with K-tier
`align_traceback_rows_multi_packed` calls — one dispatch + one pull per
tier instead of per bucket. Everything must stay bit-identical to the
single-bucket unpacked program.
"""

import numpy as np
import pytest

from hairsplitter_jax.core.mapping import _tier_plan
from hairsplitter_jax.ops.align import BandSpec
from hairsplitter_jax.ops.align_device import (
    align_traceback_rows,
    align_traceback_rows_multi_packed,
    align_traceback_rows_packed,
    pack_nibbles_host,
)
from tests.test_traceback_rows import random_batch


def test_tier_plan():
    assert _tier_plan(1) == [1]
    assert _tier_plan(3) == [1, 1, 1]
    assert _tier_plan(5) == [4, 1]
    assert _tier_plan(17) == [16, 1]
    assert _tier_plan(23) == [16, 4, 1, 1, 1]
    assert sum(_tier_plan(37)) == 37


def test_pack_nibbles_roundtrip_odd_width():
    rng = np.random.default_rng(0)
    a = rng.integers(0, 8, (3, 7)).astype(np.int8)  # odd L
    p = pack_nibbles_host(a)
    assert p.shape == (3, 4)
    lo = (p & 0xF).astype(np.int8)
    hi = (p >> 4).astype(np.int8)
    back = np.stack([lo, hi], axis=-1).reshape(3, 8)[:, :7]
    np.testing.assert_array_equal(back, a)


@pytest.mark.parametrize("chunk,band", [(48, 32), (64, 128)])
def test_multi_packed_equals_single(chunk, band):
    spec = BandSpec(chunk=chunk, band=band)
    B, T = spec.chunk, spec.t_width
    rng = np.random.default_rng(2)
    K, n = 3, 32
    singles = []
    qs, qls, ts, tls, ms = [], [], [], [], []
    for _ in range(K):
        q, ql, t, tl = random_batch(rng, n, spec)
        m = (np.arange(n) % 2).astype(np.int32)
        singles.append(np.asarray(align_traceback_rows(q, ql, t, tl, m, spec)))
        qs.append(pack_nibbles_host(q))
        ts.append(pack_nibbles_host(t))
        qls.append(ql)
        tls.append(tl)
        ms.append(m)
    multi = np.asarray(
        align_traceback_rows_multi_packed(
            np.stack(qs), np.stack(qls), np.stack(ts), np.stack(tls), np.stack(ms), spec, B, T
        )
    )
    for k in range(K):
        np.testing.assert_array_equal(multi[k], singles[k])
    # packed single == unpacked single too
    got = np.asarray(
        align_traceback_rows_packed(qs[0], qls[0], ts[0], tls[0], ms[0], spec, B, T)
    )
    np.testing.assert_array_equal(got, singles[0])
