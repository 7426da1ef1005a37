"""Chi-squared keep/rescue decisions near their thresholds: f32 vs f64.

On the GPU the robust-variant filter computes the 2x2 Pearson chi² in
float32 (`ops/variants.py:_chi2_dev`, closed form with an exact integer
determinant); the CPU backend's host twin
(`pipeline/call_variants.py:_chi2_tables`, expected-count form) computes in
float64. The contingency counts are exact in both (0/1 products summed
below 2^24), so the statistics differ only by rounding - and integer tables
land EXACTLY on a threshold (n = 15 reads in a perfect split: chi² = n =
15), where a plain `chi > thr` would be decided by that rounding.

The code's rule (`chi2_above`): keep iff chi > thr * (1 + 1e-5), so exact
ties and anything within 1e-5 above a threshold are not kept. These tests
enumerate every table with cells <= 40 whose chi² lies within 1e-3 of
`chi2_keep` or `chi2_rescue`, show that a plain strict comparison splits
f32 from f64 at the exact ties, and that the rule decides every table alike.
On tables of 1000 to 90000 reads the f32 statistic stays within 1e-6 of the
f64 one, so the two disagree only on a table within 1e-6 of the band's edge
thr * (1 + 1e-5): none exists with cells <= 40; once n is in the thousands,
about 1 in 10^4 of the tables within 1e-3 of a threshold is such a table.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from hairsplitter_jax.ops.variants import _chi2_dev, chi2_above
from hairsplitter_jax.pipeline.call_variants import VariantCallConfig, _chi2_tables

CFG = VariantCallConfig()


def _tables_near(thr: float, tol: float = 1e-3, nmax: int = 40):
    r = np.arange(nmax + 1, dtype=np.float64)
    g = np.stack(np.meshgrid(r, r, r, r, indexing="ij"), -1).reshape(-1, 4)
    chi = _chi2_tables(g[:, 0], g[:, 1], g[:, 2], g[:, 3])
    sel = np.abs(chi - thr) <= tol
    return g[sel], chi[sel]


def _stats(thr):
    tables, chi64 = _tables_near(thr)
    chi32 = np.asarray(_chi2_dev(*(jnp.asarray(tables[:, i], jnp.float32) for i in range(4))))
    return tables, chi64, chi32


@pytest.mark.parametrize("thr", [CFG.chi2_keep, CFG.chi2_rescue], ids=["keep", "rescue"])
def test_plain_strict_comparison_splits_at_exact_ties(thr):
    tables, chi64, chi32 = _stats(thr)
    assert len(tables) > 100  # the band is populated
    # float32 rounding of the statistic: a few ulps at this magnitude
    np.testing.assert_allclose(chi32, chi64, rtol=1e-6, atol=0)
    differ = (chi64 > thr) != (chi32 > np.float32(thr))
    assert differ.any()
    # every disagreement is a table whose exact chi² is the threshold
    assert np.all(np.abs(chi64[differ] - thr) < 1e-9), chi64[differ]


@pytest.mark.parametrize("thr", [CFG.chi2_keep, CFG.chi2_rescue], ids=["keep", "rescue"])
def test_tie_rule_decides_f32_and_f64_alike(thr):
    tables, chi64, chi32 = _stats(thr)
    d64 = chi2_above(chi64, thr)
    d32 = np.asarray(chi2_above(jnp.asarray(chi32), jnp.float32(thr)))
    np.testing.assert_array_equal(d32, d64)
    ties = np.abs(chi64 - thr) < 1e-9
    assert ties.any() and not d64[ties].any()  # exact ties are never kept
    assert d64[chi64 > thr * (1 + 2e-5)].all()  # clear passes are


def _large_tables_near(thr: float, n: int, tol: float = 1e-3, draws: int = 400_000):
    """Tables of exactly n reads whose chi² lies within tol (relative) of
    thr: random margins, the n11 cell solved for chi² = thr and rounded."""
    rng = np.random.default_rng(n)
    r1 = rng.integers(1, n, draws).astype(np.float64)
    c1 = rng.integers(1, n, draws).astype(np.float64)
    r0, c0 = n - r1, n - c1
    det = np.sqrt(thr * r0 * r1 * c0 * c1 / n) * rng.choice([-1.0, 1.0], draws)
    n11 = np.round((r1 * c1 + det) / n)
    n10, n01 = r1 - n11, c1 - n11
    n00 = n - n11 - n10 - n01
    g = np.stack([n00, n01, n10, n11], 1)
    g = g[(g >= 0).all(1)]
    chi = _chi2_tables(*g.T)
    sel = np.abs(chi - thr) <= tol * thr
    return g[sel], chi[sel]


@pytest.mark.parametrize("n", [1_000, 5_000, 20_000, 90_000])
@pytest.mark.parametrize("thr", [CFG.chi2_keep, CFG.chi2_rescue], ids=["keep", "rescue"])
def test_f32_chi2_within_tie_band_at_large_n(thr, n):
    tables, chi64 = _large_tables_near(thr, n)
    assert len(tables) > 20
    chi32 = np.asarray(_chi2_dev(*(jnp.asarray(tables[:, i], jnp.float32) for i in range(4))))
    rel = np.abs(chi32.astype(np.float64) - chi64) / chi64
    assert rel.max() < 1e-6, rel.max()  # a tenth of the tie band
    d32 = np.asarray(chi2_above(jnp.asarray(chi32), jnp.float32(thr)))
    d64 = chi2_above(chi64, thr)
    edge = thr * (1 + 1e-5)
    sliver = np.abs(chi64 - edge) <= 1e-6 * edge
    # every disagreement sits within 1e-6 of the edge
    np.testing.assert_array_equal(d32[~sliver], d64[~sliver])
