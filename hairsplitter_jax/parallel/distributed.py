"""Multi-process distributed runtime (jax.distributed over GPUs or hosts).

The reference is strictly single-node shared-memory: an OpenMP `parallel for`
over contigs with one critical-section reduction for the global error rate
(`src/call_variants.cpp:1276-1371,1310-1316`) and no distributed backend of
any kind. This module provides the missing layer from scratch — as a small
`Comm` collective surface that `pipeline.orchestrate.run_pipeline` consumes
directly, so the distributed pipeline IS the single-process pipeline (same
presets, low-memory mode, ploidy capping, POA polish ladder, COL/GRO
artifacts and resume; nothing forked):

  stage 2 (mapping)      — READ data parallelism: every process maps its
                           slice of the read set against the full minimizer
                           index, then alignments are all-gathered.
  stages 3-4 (variants / — CONTIG data parallelism (the reference's OpenMP
  separation)              axis): contigs greedily size-balanced across
                           processes; the global error rate is an all-reduce
                           of (mismatch, cell) sums — the distributed form
                           of the reference's omp-critical accumulation.
  stages 5-6 (new contigs— process 0: graph surgery and untangling are
  / untangling)            pointer-chasing host work on data already reduced
                           by orders of magnitude; process 0 also writes
                           every artifact.

All collectives ride `multihost_utils.process_allgather` (NCCL between
GPUs, gloo on the CPU backend), and the result on process 0 is bit-identical to a single-process `run_pipeline` on
the same inputs — including on noisy data with the POA ladder active and
with `-c` ploidy capping (tests/test_distributed.py).

Launch (one command per process; on one host with several GPUs give each
process its own card with --local-device-ids I, or every process opens
every card and the second one runs out of memory):
  python -m hairsplitter_jax.parallel.distributed \
      --coordinator HOST:PORT --num-processes N --process-id I \
      [--local-device-ids I] -i assembly.gfa -f reads.fa -o outdir
"""

from __future__ import annotations

import argparse
import os
import pickle
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class DistConfig:
    coordinator: str = ""  # "host:port" of process 0; required for N > 1
    num_processes: int = 1
    process_id: int = 0
    # CPU-backend emulation: devices per process (0 = leave platform alone)
    cpu_devices_per_process: int = 0
    # local devices this process may open (None = all of the host's)
    local_device_ids: tuple[int, ...] | None = None

    def __post_init__(self):
        if self.num_processes > 1 and not self.coordinator:
            raise ValueError("a multi-process run needs a coordinator address (host:port)")


def init_runtime(dist: DistConfig) -> None:
    """Initialise jax.distributed and the compile cache BEFORE any backend
    use."""
    import jax

    from ..runtime import init_compile_cache

    init_compile_cache()
    if dist.cpu_devices_per_process:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", dist.cpu_devices_per_process)
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
    if dist.num_processes > 1:
        jax.distributed.initialize(
            coordinator_address=dist.coordinator,
            num_processes=dist.num_processes,
            process_id=dist.process_id,
            local_device_ids=list(dist.local_device_ids) if dist.local_device_ids else None,
        )


def shard_items(sizes: dict[str, int], num_processes: int, process_id: int) -> list[str]:
    """Deterministic size-balanced partition (greedy largest-first)."""
    loads = [0] * num_processes
    owner: dict[str, int] = {}
    for name in sorted(sizes, key=lambda n: (-sizes[n], n)):
        p = int(np.argmin(loads))
        loads[p] += sizes[name]
        owner[name] = p
    return [n for n, p in owner.items() if p == process_id]


def allreduce_sum(values: np.ndarray) -> np.ndarray:
    """Sum a small fixed-shape float array across all processes."""
    from jax.experimental import multihost_utils

    g = multihost_utils.process_allgather(np.asarray(values, np.float64))
    return np.asarray(g).sum(axis=0)


def allgather_blobs(blob: bytes) -> list[bytes]:
    """All-gather variable-length byte strings (pad to max, then cut)."""
    from jax.experimental import multihost_utils

    n = np.asarray([len(blob)], np.int32)
    lens = np.asarray(multihost_utils.process_allgather(n)).ravel()
    m = int(lens.max())
    buf = np.zeros(m, np.uint8)
    if blob:
        buf[: len(blob)] = np.frombuffer(blob, np.uint8)
    allbuf = np.asarray(multihost_utils.process_allgather(buf))
    return [allbuf[i, : lens[i]].tobytes() for i in range(len(lens))]


class Comm:
    """The communication surface `pipeline.orchestrate.run_pipeline` uses to
    run distributed — a handful of collectives over `jax.distributed`
    processes. Single code path: run_pipeline(comm=Comm()) is the WHOLE
    distributed pipeline; there is no separate stage sequence to drift."""

    def __init__(self):
        import jax

        self.me = jax.process_index()
        self.nproc = jax.process_count()

    def owned(self, sizes: dict[str, int]) -> list[str]:
        """This process's contig shard (deterministic size-balanced)."""
        return shard_items(sizes, self.nproc, self.me)

    def allreduce_sum(self, values: np.ndarray) -> np.ndarray:
        return allreduce_sum(values)

    def allgather_obj(self, obj) -> list:
        """All-gather one picklable object per process (by process id)."""
        return [pickle.loads(b) for b in allgather_blobs(pickle.dumps(obj))]

    def bcast_obj(self, obj, root: int = 0):
        """Broadcast a picklable object from `root` (collective: every
        process must call; non-root may pass None)."""
        return self.allgather_obj(obj)[root]

    def barrier(self) -> None:
        self.allreduce_sum(np.zeros(1))


def run_pipeline_distributed(
    assembly_path: str,
    reads_path: str,
    out_dir: str,
    cfg=None,
    dist: DistConfig = DistConfig(),
):
    """Run the ONE pipeline code path under jax.distributed: reads sharded
    for mapping, contigs for variants/separation, error rate all-reduced,
    graph stages + every artifact on process 0. All flags (presets,
    low-memory, ploidy, POA ladder, resume, COL/GRO) behave exactly as
    `run_pipeline` single-process, because it IS `run_pipeline`.
    Returns the final GFA path on process 0, None elsewhere."""
    from ..pipeline.orchestrate import PipelineConfig, run_pipeline

    return run_pipeline(
        assembly_path, reads_path, out_dir, cfg or PipelineConfig(), comm=Comm()
    )


def main(argv=None):
    ap = argparse.ArgumentParser(description="distributed hairsplitter_jax")
    ap.add_argument("--coordinator", default="", help="host:port of process 0")
    ap.add_argument("--num-processes", type=int, default=1)
    ap.add_argument("--process-id", type=int, default=0)
    ap.add_argument("--cpu-devices", type=int, default=0, help="CPU emulation: devices/process")
    ap.add_argument(
        "--local-device-ids", default="",
        help="comma-separated local devices this process opens (default all)",
    )
    ap.add_argument("-i", dest="assembly", required=True)
    ap.add_argument("-f", dest="reads", required=True)
    ap.add_argument("-o", dest="out", required=True)
    ap.add_argument("-c", dest="haploid_coverage", type=float, default=0.0)
    ap.add_argument("-x", dest="technology", default="ont")
    ap.add_argument("-s", dest="dont_simplify", action="store_true")
    ap.add_argument("-l", dest="low_memory", action="store_true")
    ap.add_argument("--resume", action="store_true")
    args = ap.parse_args(argv)
    local = tuple(int(x) for x in args.local_device_ids.split(",")) if args.local_device_ids else None
    dist = DistConfig(
        args.coordinator, args.num_processes, args.process_id, args.cpu_devices, local
    )
    init_runtime(dist)
    from ..pipeline.orchestrate import PipelineConfig

    cfg = PipelineConfig(
        technology=args.technology,
        haploid_coverage=args.haploid_coverage,
        dont_simplify=args.dont_simplify,
        low_memory=args.low_memory,
        resume=args.resume,
        no_clean=True,
    )
    run_pipeline_distributed(args.assembly, args.reads, args.out, cfg, dist=dist)


if __name__ == "__main__":
    main()
