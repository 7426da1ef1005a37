"""hairsplitter_jax — a JAX haplotype-splitting engine for the GPU.

Given a (possibly collapsed) long-read assembly (GFA/FASTA) and the reads used to
build it, this framework detects contigs that mix several haplotypes / strains /
repeat copies, separates the reads per haplotype, re-polishes one contig version
per read group and emits a haplotype-resolved assembly graph.

Capabilities mirror RolandFaure/Hairsplitter (see SURVEY.md) but the design is
accelerator-first:

- read↔contig alignment runs as a batched banded DP on the GPU (replaces
  minimap2 base-level alignment + edlib, reference `src/edlib/`),
- pileup variant calling and SNP filtering are batched JAX ops
  (reference `src/call_variants.cpp`),
- read separation is dense masked matmuls + matmul label propagation on device
  (reference `src/separate_reads.cpp`, `src/cluster_graph.cpp`),
- per-cluster consensus/polishing is an on-device pileup-consensus kernel
  (replaces the reference's racon/samtools subprocess ladder, `src/tools.cpp`),
- contig graph surgery / untangling stays on host
  (reference `src/create_new_contigs.cpp`, `src/GraphUnzip/`).
"""

__version__ = "0.4.0"
