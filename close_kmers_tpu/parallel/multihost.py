"""Multi-host runtime helpers: jax.distributed initialization, host-level
input sharding, and the pod-slice serving recipe.

The reference is strictly single-node (SURVEY.md §2.8); its only
parallel-IO pieces are parallel_read (per-thread byte ranges of one file,
/root/reference/parallel_read.cc:44-94) and per-file TBB loops.  The
equivalents here:

* :func:`initialize` — bring up the jax.distributed runtime so a pod
  slice's hosts form one mesh; table shards stay within a host's cards,
  data parallelism spans hosts.
* :func:`host_shard` / :func:`partition_file_ranges` — deterministic
  host-level work partitioning for input pipelines: each host parses its
  own slice of the input files (the parallel_read analogue at host
  granularity, including the skip-partial-first-line rule).
* :func:`pod_mesh` — build the global ("data", "table") mesh across all
  processes; combined with parallel.sharding.ShardedDB this serves a
  ~1e9-kmer table across a pod slice: each host device_puts only the
  table shards its local devices own (jax.device_put with a NamedSharding
  on a global mesh does exactly this).
"""

from __future__ import annotations

import os


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Initialize jax.distributed from args or the standard env vars
    (no-op when single-process)."""
    import jax

    if num_processes is None:
        num_processes = int(os.environ.get("JAX_NUM_PROCESSES", "1"))
    if num_processes <= 1:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address
        or os.environ.get("JAX_COORDINATOR_ADDRESS"),
        num_processes=num_processes,
        process_id=process_id
        if process_id is not None else int(os.environ["JAX_PROCESS_ID"]))


def pod_mesh(n_data: int | None = None, n_table: int | None = None):
    """Global ("data", "table") mesh over every device in the pod slice.
    Defaults: table spans the devices of one host, data spans hosts."""
    import jax
    from .sharding import make_mesh

    devices = jax.devices()
    if n_data is None and n_table is None:
        n_table = max(1, jax.local_device_count())
        n_data = len(devices) // n_table
    return make_mesh(n_data, n_table, devices=devices)


def replicate_to_global(mesh, *arrays):
    """Host-local numpy inputs -> fully-replicated global arrays on a
    multi-process mesh (every process must pass identical values).  A
    no-op passthrough in single-process runs."""
    import jax

    if jax.process_count() == 1:
        return arrays
    from jax.experimental import multihost_utils
    from jax.sharding import PartitionSpec as P

    return tuple(
        multihost_utils.host_local_array_to_global_array(a, mesh, P())
        for a in arrays)


def addressable_rows(arr):
    """Yield (index_tuple, numpy_data) for the shards of a (possibly
    global, multi-process) jax.Array that live on THIS process — the
    verification/consumption primitive for sharded step outputs when no
    cross-process gather is wanted."""
    import numpy as np

    for sh in arr.addressable_shards:
        yield sh.index, np.asarray(sh.data)


def host_shard(items: list, process_id: int | None = None,
               num_processes: int | None = None) -> list:
    """Deterministic round-robin split of a work list across hosts."""
    import jax

    pid = process_id if process_id is not None else jax.process_index()
    n = num_processes if num_processes is not None else jax.process_count()
    return items[pid::n]


def partition_file_ranges(file_size: int, n_parts: int) -> list[tuple[int, int]]:
    """Byte ranges for parallel line-oriented reading, parallel_read
    parity (parallel_read.cc:44-94): part i spans [i*sz/n, (i+1)*sz/n);
    a reader discards its first partial line (unless it is part 0) and
    reads past its end boundary to finish its last line."""
    out = []
    for i in range(n_parts):
        a = file_size * i // n_parts
        b = file_size * (i + 1) // n_parts
        out.append((a, b))
    return out


def read_lines_in_range(path: str, start: int, end: int):
    """Yield the complete lines owned by byte range [start, end):
    skip the partial first line when start > 0; finish the line that
    straddles ``end``."""
    with open(path, "rb") as f:
        f.seek(start)
        if start > 0:
            f.readline()  # discard partial line (owned by previous range)
        while f.tell() < end:
            line = f.readline()
            if not line:
                break
            yield line.decode("latin-1").rstrip("\n")
