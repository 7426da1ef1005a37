from hairsplitter_jax.io.gfa import AssemblyGraph, Link
from hairsplitter_jax.pipeline.multiplicity import (
    determine_multiplicity,
    estimate_haploid_coverage,
)


def _diamond():
    # trunk T (depth 40) splits into A, B (20 each) and rejoins at T2 (40)
    g = AssemblyGraph()
    g.add_segment("T", "A" * 5000, depth=40)
    g.add_segment("A", "C" * 5000, depth=20)
    g.add_segment("B", "G" * 5000, depth=21)
    g.add_segment("T2", "T" * 5000, depth=39)
    g.add_link(Link("T", "+", "A", "+"))
    g.add_link(Link("T", "+", "B", "+"))
    g.add_link(Link("A", "+", "T2", "+"))
    g.add_link(Link("B", "+", "T2", "+"))
    return g


def test_haploid_coverage_estimate():
    g = _diamond()
    hc = estimate_haploid_coverage(g)
    assert 19 <= hc <= 40  # simple contigs: A, B (1 nb/side) and T/T2


def test_determine_multiplicity_diamond():
    g = _diamond()
    mult = determine_multiplicity(g, haploid_coverage=20)
    assert mult["A"] == 1 and mult["B"] == 1
    assert mult["T"] == 2 and mult["T2"] == 2


def test_multiplicity_consistency_pass():
    g = _diamond()
    # trunk depth mis-measured low: the junction sum should still win
    g.depths["T"] = 22
    mult = determine_multiplicity(g, haploid_coverage=20)
    assert mult["T"] == 2


def test_asymmetric_junction_depth_guard():
    """Reference hand-trace (`determine_multiplicity.py:55-109`): trunk T has
    two exclusive left neighbors (A, B, mult 1 each -> side sum 2) but one
    right neighbor C (mult 1 -> side sum 1). Sides disagree (no confidence),
    and T's depth (12x vs haploid 10x) fails the depth/1.5 guard for 2
    copies, so the left-side sum is vetoed; the subtraction inference from C
    (1 - 0 = 1, guard 11/10 >= 1/1.5) then sets T = 1. The old greedy
    nudge-up took max(side sums) = 2 here, over-estimating."""
    g = AssemblyGraph()
    g.add_segment("A", "A" * 5000, depth=10)
    g.add_segment("B", "C" * 5000, depth=10)
    g.add_segment("T", "G" * 5000, depth=12)
    g.add_segment("C", "T" * 5000, depth=11)
    g.add_link(Link("A", "+", "T", "+"))
    g.add_link(Link("B", "+", "T", "+"))
    g.add_link(Link("T", "+", "C", "+"))
    support = {}
    mult = determine_multiplicity(g, haploid_coverage=10, supported_links=support)
    assert mult == {"A": 1, "B": 1, "T": 1, "C": 1}
    # supported-links bookkeeping records the subtraction-inferred T<-C link
    assert (("C", 0), ("T", 1)) in support and support[(("C", 0), ("T", 1))] == 1


def test_unreliable_coverage_disables_guard():
    """refCoverage <= 1 marks depths unreliable: every junction sum is
    accepted without a depth guard (`determine_multiplicity.py:34-38,74`)."""
    g = _diamond()
    for n in g.depths:
        g.depths[n] = 0
    mult = determine_multiplicity(g)
    assert mult["A"] == 1 and mult["B"] == 1
    assert mult["T"] == 2 and mult["T2"] == 2
