import numpy as np

from hairsplitter_jax.constants import revcomp
from hairsplitter_jax.utils.evaluate import evaluate_phasing
from hairsplitter_jax.utils.sim import make_haplotypes, mutate


def test_evaluate_pure_contigs(rng):
    h1 = make_haplotypes(8000, 1, 0.001, rng)[0]
    h2, _ = mutate(h1, 0.01, rng)
    ev = evaluate_phasing({"a": h1, "b": revcomp(h2)}, [h1, h2])
    assert ev.total_switch_errors == 0
    assert ev.mean_identity > 0.99
    assert {c.best_haplotype for c in ev.contigs} == {0, 1}
    assert min(ev.haplotype_recovery) > 0.99


def test_evaluate_detects_switch_error(rng):
    h1 = make_haplotypes(12000, 1, 0.001, rng)[0]
    h2, _ = mutate(h1, 0.01, rng)
    chimera = h1[:6000] + h2[6000:]
    ev = evaluate_phasing({"chim": chimera}, [h1, h2])
    assert ev.total_switch_errors >= 1
    # half the content belongs to the other haplotype -> recovery split
    assert all(r < 0.9 for r in ev.haplotype_recovery)
