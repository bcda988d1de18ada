"""Scaling-efficiency harness: the full sharded annotation step over
1/2/4/..-device meshes (SURVEY.md §7 step 6).

On a multi-card host this measures strong-scaling efficiency of the
range-sharded DB design (probe + psum merge + scoring scan + family
rollup); on the CPU backend (JAX_PLATFORMS=cpu
XLA_FLAGS=--xla_force_host_platform_device_count=8) it validates the
sharded path end-to-end and reports relative per-device overhead —
useful for spotting collective-layout regressions without cards.

Two mesh splits are exercised per device count S:
  table: 1 x S  — DB range-sharded (the memory-scaling axis)
  data:  S x 1  — batch data-parallel (the throughput-scaling axis)

Usage: [BENCH_* env] python scripts/scaling_bench.py [max_devices]
       python scripts/scaling_bench.py --cpu [max_devices]   # virtual 8-dev mesh
       python scripts/scaling_bench.py --multiproc N         # N local processes
Prints one line per (split, S): ms/batch, proteins/s, efficiency vs S=1.

--multiproc N spawns N jax.distributed processes on localhost (CPU
backend, 4 virtual devices each) via scripts/multiproc_worker.py
--bench and reports per-process throughput — the same launch shape as a
multi-host deployment, where each host runs
  JAX_COORDINATOR_ADDRESS=<host0>:<port> JAX_NUM_PROCESSES=<H> \
  JAX_PROCESS_ID=<i> kser ... (multihost.initialize picks these up).

--cpu forces the virtual 8-device CPU mesh, like tests/conftest.py.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

if "--multiproc" in sys.argv:
    i = sys.argv.index("--multiproc")
    nproc = int(sys.argv[i + 1])
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sock = socket.socket(); sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]; sock.close()
    env = dict(os.environ, PYTHONPATH=repo)
    env.pop("JAX_PLATFORMS", None)
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(repo, "scripts", "multiproc_worker.py"),
         str(j), str(nproc), str(port), "--bench"], env=env)
        for j in range(nproc)]
    sys.exit(max(p.wait() for p in procs))

if "--cpu" in sys.argv:
    sys.argv.remove("--cpu")
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()
    import jax
    jax.config.update("jax_platforms", "cpu")

os.environ.setdefault("BENCH_N_SRC", "8000")
os.environ.setdefault("BENCH_N_QUERY", "2048")
import bench  # noqa: E402

import jax  # noqa: E402

from close_kmers_tpu.parallel.sharding import (  # noqa: E402
    ShardedDB, serve_step_sharded, make_mesh, shard_fam_table)

K_HI = 8
K_LO = 2


def run_config(db, offsets, lengths, fam_np, n_data, n_table):
    devices = jax.devices()[: n_data * n_table]
    mesh = make_mesh(n_data=n_data, n_table=n_table, devices=devices)
    sdb = ShardedDB.from_db(db, mesh)
    fam_sh = shard_fam_table(fam_np, sdb)
    B = offsets.shape[0]

    def step():
        out = serve_step_sharded(sdb, offsets, lengths,
                                 fam_shards=fam_sh, cap_seq=16,
                                 routed=False)
        jax.block_until_ready(out)
        return out

    step()  # compile + warm

    def timed(k):
        t0 = time.time()
        for _ in range(k):
            step()
        return time.time() - t0

    t = (timed(K_HI) - timed(K_LO)) / (K_HI - K_LO)
    return t, B / t


def main():
    max_dev = int(sys.argv[1]) if len(sys.argv) > 1 else len(jax.devices())
    rng = np.random.default_rng(0)
    db, offsets, lengths = bench.build_corpus(rng)
    B = offsets.shape[0] if offsets.shape[0] <= 2048 else 2048
    offsets, lengths = offsets[:B], lengths[:B]
    fam_np = np.full((len(db) + 1, 2), -1, dtype=np.int32)
    fam_np[: len(db), 0] = db.fi
    fam_np[: len(db) // 2, 1] = db.fi[: len(db) // 2] + 1

    print(f"devices={len(jax.devices())} backend={jax.default_backend()} "
          f"B={B} DB={len(db):,}", flush=True)
    sizes = [s for s in (1, 2, 4, 8, 16) if s <= max_dev]
    for axis in ("table", "data"):
        base = None
        for s in sizes:
            nd, nt = (s, 1) if axis == "data" else (1, s)
            t, rate = run_config(db, offsets, lengths, fam_np, nd, nt)
            base = base or rate
            eff = rate / (base * s)
            print(f"{axis}={s:<3d} {t*1000:8.2f} ms/batch "
                  f"{rate:10.0f} proteins/s  eff={eff:5.2f}", flush=True)


if __name__ == "__main__":
    main()
