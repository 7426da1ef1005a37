import numpy as np

from hairsplitter_jax.constants import revcomp
from hairsplitter_jax.core.assembler import greedy_assemble
from hairsplitter_jax.utils.sim import random_genome, simulate_reads


def _containment(a, b, k=31):
    ka = {a[i : i + k] for i in range(0, len(a) - k + 1, 5)}
    kb = {b[i : i + k] for i in range(len(b) - k + 1)}
    kb |= {revcomp(b)[i : i + k] for i in range(len(b) - k + 1)}
    return len(ka & kb) / max(1, len(ka))


def test_greedy_assemble_recovers_genome(rng):
    genome = random_genome(6000, rng)
    sim = simulate_reads([genome], coverage=10, read_len=1500, rng=rng)
    reads = {n: s for n, s in zip(sim.names, sim.seqs)}
    contigs = greedy_assemble(reads)
    assert contigs, "no contigs assembled"
    longest = max(contigs, key=len)
    assert len(longest) > 0.8 * len(genome), len(longest)
    assert _containment(longest, genome) > 0.95


def test_greedy_assemble_two_molecules(rng):
    g1 = random_genome(4000, rng)
    g2 = random_genome(4000, rng)
    sim = simulate_reads([g1, g2], coverage=10, read_len=1200, rng=rng)
    reads = {n: s for n, s in zip(sim.names, sim.seqs)}
    contigs = greedy_assemble(reads)
    # both molecules should be represented, no chimeras
    best1 = max(_containment(c, g1) for c in contigs)
    best2 = max(_containment(c, g2) for c in contigs)
    assert best1 > 0.9 and best2 > 0.9
    for c in contigs:
        assert max(_containment(c, g1), _containment(c, g2)) > 0.9, "chimeric contig"


def test_greedy_assemble_empty():
    assert greedy_assemble({}) == []
