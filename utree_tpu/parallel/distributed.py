"""Multi-host deployment helpers.

The reference is strictly single-node (SURVEY.md §2.3).  Multi-host here is
standard JAX SPMD: one process per host (`jax.distributed.initialize`), a
global mesh over all devices, per-host input pipelines feeding each host's
addressable shard of the read batch, and deterministic collective merges so
sample-level outputs are bit-identical at any host count.

This module is exercised on single-process virtual meshes and two local
processes in the tests; on real hosts call `init_distributed()` before
anything else touches JAX.
"""

from __future__ import annotations

import jax
import numpy as np


def init_distributed(coordinator: str | None = None, num_processes: int | None = None,
                     process_id: int | None = None) -> None:
    """Initialize multi-process JAX (one process per host).  No-ops on a
    single process with no coordinator configured."""
    if coordinator is None and num_processes is None:
        return  # single process
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )


def host_read_range(total_reads: int, process_index: int | None = None,
                    process_count: int | None = None) -> tuple[int, int]:
    """Deterministic per-host slice of the read set: host h takes the
    contiguous range [h*ceil(N/H), ...) so global read order (and therefore
    merged output order) is independent of host count."""
    h = jax.process_index() if process_index is None else process_index
    nh = jax.process_count() if process_count is None else process_count
    per = -(-total_reads // nh)
    lo = min(h * per, total_reads)
    return lo, min(lo + per, total_reads)


def merge_sample_tallies(local_tally: np.ndarray, mesh) -> np.ndarray:
    """Sum per-label tallies across the whole mesh (integer psum — exact and
    order-independent, unlike the reference's thread-completion-order writes,
    itree.c:1009-1101)."""
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    # `local_tally` is a PER-HOST value replicated over this host's local
    # devices; a bare psum over the mesh would overcount by devices-per-host.
    # Weight each device's contribution so exactly one device per process
    # (its first, in mesh order) contributes — exact for any device layout.
    seen: set[int] = set()
    weights = np.zeros(mesh.devices.shape, np.int64)
    for pos, dev in np.ndenumerate(mesh.devices):
        if dev.process_index not in seen:
            seen.add(dev.process_index)
            weights[pos] = 1

    def f(x, w):
        return jax.lax.psum(x * w.reshape(()), ("data", "table"))

    return np.asarray(
        jax.jit(
            jax.shard_map(f, mesh=mesh,
                          in_specs=(P(), P(*mesh.axis_names)), out_specs=P())
        )(jnp.asarray(local_tally), jnp.asarray(weights))
    )


def count_fasta_records(path: str, chunk_bytes: int = 64 << 20) -> int:
    """Record count of a linearized FASTA, streamed (every host needs the
    total to compute its slice)."""
    n = 0
    first = True
    prev_nl = False  # did the previous chunk end with '\n'?
    with open(path, "rb") as f:
        while True:
            chunk = f.read(chunk_bytes)
            if not chunk:
                return n
            if first:
                first = False
                if chunk.startswith(b">"):
                    n += 1
            elif prev_nl and chunk.startswith(b">"):
                # '\n>' straddling the chunk boundary
                n += 1
            n += chunk.count(b"\n>")
            prev_nl = chunk.endswith(b"\n")


def search_file_multihost(pipe, reads_path: str, out_path: str, *,
                          resume: bool = False) -> int:
    """Multi-host search driver — the end-to-end form of BASELINE's
    "report at N>=2 hosts".

    Every process (one per host; `init_distributed` first) takes the
    contiguous record range `host_read_range` gives it, runs its own
    SearchPipeline over that slice into `<out>.part<h>`, and host 0
    concatenates the parts in host order — records are partitioned
    contiguously and each line's content depends only on its read, so the
    merged bytes equal a single-host run exactly.  Per-host classified/read
    counts merge with an exact integer psum (merge_sample_tallies).

    Requires a shared filesystem across hosts;
    the reads file must be plain FASTA (range partitioning seeks by record).
    Returns the number of records this host searched."""
    import pathlib

    from jax.sharding import Mesh

    total = count_fasta_records(reads_path)
    h = jax.process_index()
    nh = jax.process_count()
    lo, hi = host_read_range(total)
    part = f"{out_path}.part{h}"
    n = pipe.search_file(reads_path, part, resume=resume, record_range=(lo, hi))

    # count lines written (classified reads) for the merged tally
    lines = 0
    with open(part, "rb") as f:
        for _ in f:
            lines += 1

    devices = np.array(jax.devices()).reshape(-1, 1)
    mesh = Mesh(devices, ("data", "table"))
    merged = merge_sample_tallies(np.array([n, lines], np.int64), mesh)

    # the collective above is also the barrier: every host has written and
    # closed its part before any host reaches this point
    if h == 0:
        with open(out_path, "wb") as fo:
            for i in range(nh):
                pp = pathlib.Path(f"{out_path}.part{i}")
                fo.write(pp.read_bytes())
                pp.unlink()
        print(f"multihost: {int(merged[0])} reads searched, "
              f"{int(merged[1])} classified across {nh} hosts")
    return n
