"""Card-only tests: the device paths compiled for the GPU against their
host twins - the fused mapping call against the native C++ aligner, and the
stage-3 chi² gates against the CPU backend's f64 host path.

They need an NVIDIA GPU, decide so inside the `gpu` fixture, and skip
elsewhere; `python chip_smoke.py` runs them on the card (`pytest -m gpu`).
The same arithmetic is covered on the CPU by tests/test_traceback_rows.py,
tests/test_multi_bucket.py and tests/test_chi2_thresholds.py.
"""

import numpy as np
import pytest

from hairsplitter_jax.ops.align import BandSpec
from hairsplitter_jax.utils.sim import simulate_dp_jobs

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    import jax

    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (run on the card by chip_smoke.py)")


@pytest.mark.parametrize("chunk,band,n,err", [(256, 128, 4096, 0.08), (64, 32, 300, 0.2)])
def test_compiled_fused_call_matches_native(gpu, chunk, band, n, err):
    """Exact integer work: CIGARs, costs and clips bit-identical."""
    from hairsplitter_jax import native
    from hairsplitter_jax.ops.align_device import align_traceback_rows, expand_rows_host

    spec = BandSpec(chunk=chunk, band=band)
    q, ql, t, tl = simulate_dp_jobs(np.random.default_rng(chunk + n), n, spec, err)
    modes = (np.arange(n) % 2).astype(np.int32)
    fused = np.asarray(align_traceback_rows(q, ql, t, tl, modes, spec))
    ops_g, cost_g, clip_g = expand_rows_host(fused, q, t, spec)
    ops_n, cost_n, clip_n = native.banded_align_tb(q, ql, t, tl, modes, spec.band)
    np.testing.assert_array_equal(cost_g, cost_n)
    np.testing.assert_array_equal(clip_g, clip_n)
    for a, b in zip(ops_g, ops_n):
        np.testing.assert_array_equal(a, b)


def test_device_chi2_gates_match_host(gpu):
    """The three chi² gates on the card (f32) decide as the CPU backend's
    host twins (f64) on planted partitions plus noise columns."""
    from hairsplitter_jax.ops import variants as V
    from hairsplitter_jax.pipeline import call_variants as C

    rng = np.random.default_rng(5)
    S, R, K = 512, 1024, 3
    part = rng.integers(0, 2, (K, R)).astype(bool)
    covered = rng.random((S, R)) < 0.3
    src = part[rng.integers(0, K, S)]
    noisy = np.where(rng.random((S, R)) < rng.uniform(0.02, 0.5, (S, 1)), ~src, src)
    A = (covered & noisy).astype(np.float32)
    Rf = (covered & ~noisy).astype(np.float32)
    pos = np.sort(rng.integers(0, 60_000, S)).astype(np.int64)
    P1, P0 = part.astype(np.float32), (~part).astype(np.float32)
    col_size = covered.sum(1).astype(np.float32)
    cfg = C.VariantCallConfig()

    corr_d, flip_d = V.pairwise_column_correlation(
        A, Rf, pos, np.float32(cfg.chi2_keep), np.int64(cfg.max_partition_span),
        np.float32(cfg.corr_margin), np.float32(cfg.corr_margin_min),
    )
    corr_h, flip_h = C.pairwise_correlation_host(
        A, Rf, pos, cfg.chi2_keep, cfg.max_partition_span, cfg.corr_margin, cfg.corr_margin_min
    )
    unpack = lambda b, n: np.unpackbits(np.asarray(b), axis=-1, bitorder="little")[..., :n].astype(bool)  # noqa: E731
    np.testing.assert_array_equal(unpack(corr_d, S), corr_h)
    np.testing.assert_array_equal(unpack(flip_d, S), flip_h)
    assert corr_h.any() and not corr_h.all()

    keep_d = V.partition_column_keep(P1, P0, A, Rf, col_size, np.float32(cfg.chi2_keep))
    keep_h = C.partition_column_keep_host(P1, P0, A, Rf, col_size, cfg.chi2_keep)
    np.testing.assert_array_equal(unpack(keep_d, S), keep_h)
    res_d = V.partition_rescue_keep(P1, P0, A, Rf, np.float32(cfg.chi2_rescue))
    res_h = C.partition_rescue_keep_host(P1, P0, A, Rf, cfg.chi2_rescue)
    np.testing.assert_array_equal(unpack(res_d, S), res_h)
    assert keep_h.any() and not keep_h.all()
