"""Worker for the multi-process jax.distributed test/bench.

Each process brings up jax.distributed on the CPU backend with N virtual
local devices, joins the global ("data", "table") mesh, and runs BOTH
the sharded probe and the FULL sharded annotation step
(serve_step_sharded: probe + psum merge + scoring scan + per-sequence
reductions + cross-shard family rollup) over two DB shapes — a
shallow-bucket one (payload-wide shard layout) and a deep-bucket one
(sub-bucket shard layout).  Every process verifies its own addressable
output shards against a single-process reference: the SAME step run over
a trivial 1-device local mesh (identical code path, psum = identity), so
any cross-process collective divergence shows up as a byte mismatch.
Exit 0 = parity.

Invoked by tests/test_multiprocess.py and scripts/scaling_bench.py:
    python scripts/multiproc_worker.py <pid> <nproc> <port> [--bench]
"""

from __future__ import annotations

import os
import sys
import time


def build_db(rng, deep: bool):
    import numpy as np
    from close_kmers_tpu.db.signature_db import SignatureDB
    from close_kmers_tpu.params import LO_CARD

    if deep:
        # ~60 hi buckets over 8k keys: avg depth ~130 >> WIDE_BUCKET_MAX,
        # so ShardedDB builds the sub-bucket block layout per shard
        n = 8_000
        his = rng.integers(1_000_000, 1_000_060, size=n, dtype=np.int64)
    else:
        n = 30_000
        his = rng.integers(0, 3_200_000, size=n, dtype=np.int64)
    keys = np.unique(his * LO_CARD
                     + rng.integers(0, LO_CARD, size=n, dtype=np.int64))
    return SignatureDB(
        keys,
        rng.integers(0, 50, size=len(keys)).astype(np.int32),
        rng.integers(-1, 9, size=len(keys)).astype(np.int32),
        rng.integers(0, 300, size=len(keys)).astype(np.int32),
        rng.uniform(0.1, 4.0, size=len(keys)).astype(np.float32),
    )


def build_mapping(rng, db):
    """Synthetic kmer->family CSR over the DB keys (degree 1-3)."""
    import numpy as np
    from close_kmers_tpu.db.family_db import KmerFamilyMapping

    n = len(db)
    deg = rng.integers(1, 4, size=n)
    offs = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(deg, out=offs[1:])
    vals = np.repeat(db.fi * 3, deg) + (np.arange(offs[-1]) % 3) \
        .astype(np.int32)
    mapping = KmerFamilyMapping()
    mapping._fam_csr = (db.keys, offs, vals.astype(np.int32))
    return mapping


def load_midsize(path: str):
    """A >= 10M-key SignatureDB for the cross-process fixture: two
    disjoint slices of a real scale-build npz when available (uneven hi
    occupancy — the low range is ~4x denser per hi bucket than the high
    tail), else an equivalent synthetic shape."""
    import numpy as np
    from close_kmers_tpu.db.signature_db import SignatureDB

    if path != "synth" and os.path.exists(path):
        z = np.load(path)
        keys_all = z["keys"]
        n = len(keys_all)
        a = slice(0, 8_000_000)
        b = slice(n - 2_000_000, n)
        keys = np.concatenate([keys_all[a], keys_all[b]])
        fi = np.concatenate([z["fi"][a], z["fi"][b]]).astype(np.int32)
        oi = np.concatenate([z["oi"][a], z["oi"][b]]).astype(np.int32)
        av = np.concatenate([z["avg_off"][a], z["avg_off"][b]]) \
            .astype(np.int32)
        wt = np.concatenate([z["wt"][a], z["wt"][b]]).astype(np.float32)
        return SignatureDB(keys, fi, oi, av, wt)
    rng = np.random.default_rng(7)
    from close_kmers_tpu.params import LO_CARD, HI_CARD
    lows = rng.integers(0, HI_CARD // 8, size=8_000_000, dtype=np.int64)
    highs = rng.integers(HI_CARD - HI_CARD // 32, HI_CARD,
                         size=2_000_000, dtype=np.int64)
    his = np.concatenate([lows, highs])
    keys = np.unique(his * LO_CARD
                     + rng.integers(0, LO_CARD, size=len(his),
                                    dtype=np.int64))
    return SignatureDB(
        keys,
        rng.integers(0, 500, size=len(keys)).astype(np.int32),
        rng.integers(-1, 9, size=len(keys)).astype(np.int32),
        rng.integers(0, 300, size=len(keys)).astype(np.int32),
        rng.uniform(0.1, 4.0, size=len(keys)).astype(np.float32),
    )


def run_case(pid, mesh, mesh_local, db, rng, label: str) -> int:
    import jax
    import numpy as np
    from close_kmers_tpu.core.device_family import DeviceFamilyDB
    from close_kmers_tpu.core.engine import FastAnnotator
    from close_kmers_tpu.ops import encoder as E
    from close_kmers_tpu.parallel.multihost import (addressable_rows,
                                                    replicate_to_global)
    from close_kmers_tpu.parallel.sharding import (ShardedDB,
                                                   probe_sharded,
                                                   shard_fam_table)

    keys = db.keys
    B, L = 64, 128
    seqs = []
    for i in range(B):
        frags = [E.decode_kmer(int(keys[rng.integers(0, len(keys))]))
                 for _ in range(rng.integers(1, 12))]
        seqs.append("".join(frags)[:L - 9])

    sdb = ShardedDB.from_db(db, mesh)
    fa = FastAnnotator(db)
    offsets, lengths = fa.pad_batch(seqs, pad_to=L)
    g_off, g_len = replicate_to_global(mesh, offsets,
                                       lengths.astype(np.int32))

    mapping = build_mapping(rng, db)
    fam_np = np.asarray(DeviceFamilyDB.from_mapping(db, mapping).fam)
    fam_shards = shard_fam_table(fam_np, sdb)

    t0 = time.time()
    found, fi, oi, av, wt, hi, lo = probe_sharded(sdb, g_off, g_len)
    jax.block_until_ready(found)
    t_probe = time.time() - t0

    # single-chip probe reference, computed locally
    from close_kmers_tpu.core.engine import DeviceEngine
    rfound, rfi, roi, rav, rwt = DeviceEngine(db).probe_padded(offsets, lengths)

    n_checked = 0
    for arr, exp in ((found, rfound.astype(np.int32)),
                     (fi, np.where(rfound, rfi, 0)),
                     (oi, np.where(rfound, roi, 0)), (av, rav), (wt, rwt)):
        for idx, data in addressable_rows(arr):
            assert np.array_equal(data, exp[idx]), \
                f"proc {pid} [{label}]: probe shard {idx} mismatch"
            n_checked += 1

    # FULL serving step (replicated probe + psum merge) across
    # processes vs the same step on a trivial 1-device local mesh (psum
    # over one shard = identity)
    CAP = 8
    from close_kmers_tpu.params import EngineParams
    from close_kmers_tpu.parallel.sharding import serve_step_sharded
    params0 = EngineParams()
    t0 = time.time()
    outs = serve_step_sharded(sdb, g_off, g_len, params=params0,
                              fam_shards=fam_shards, cap_seq=CAP,
                              routed=False)
    jax.block_until_ready(outs[0])
    t_step = time.time() - t0

    sdb1 = ShardedDB.from_db(db, mesh_local)
    fam1 = shard_fam_table(fam_np, sdb1)
    ref = serve_step_sharded(sdb1, offsets, lengths.astype(np.int32),
                             params=params0, fam_shards=fam1,
                             cap_seq=CAP, routed=False)
    ref_np = [np.asarray(r) for r in ref]

    names = ("best_pack", "n_ovf", "n_drop", "fam_rollup")
    for name, arr, exp in zip(names, outs, ref_np):
        if name in ("n_ovf", "n_drop"):
            continue              # per-device counters, shapes differ
        for idx, data in addressable_rows(arr):
            assert np.array_equal(data, exp[idx]), \
                f"proc {pid} [{label}]: step output {name} shard mismatch"
            n_checked += 1

    # ROUTED serving step across processes (the one-gather-per-window
    # exchange path + real-params scoring + device best-call pack +
    # family rollup rows) vs the identical program on the trivial local
    # mesh (all_to_all/psum = identity there).
    params = EngineParams(min_hits=3, max_gap=150)
    t0 = time.time()
    r_outs = serve_step_sharded(sdb, g_off, g_len, params=params,
                                fam_shards=fam_shards, cap_seq=CAP,
                                routed=True, capacity_factor=None)
    jax.block_until_ready(r_outs[0])
    t_serve = time.time() - t0
    ref_s = serve_step_sharded(sdb1, offsets, lengths.astype(np.int32),
                               params=params, fam_shards=fam1,
                               cap_seq=CAP, routed=True,
                               capacity_factor=None)
    ref_s_np = [np.asarray(r) for r in ref_s]
    for name, arr, exp in zip(("best_pack", "n_ovf", "n_drop", "rollup"),
                              r_outs, ref_s_np):
        if name in ("n_ovf", "n_drop"):
            continue              # per-device counters, shapes differ
        for idx, data in addressable_rows(arr):
            assert np.array_equal(data, exp[idx]), \
                f"proc {pid} [{label}]: routed serve {name} shard mismatch"
            n_checked += 1
    # nothing dropped on this process's devices (global fetch is not
    # possible for non-addressable shards)
    for _idx, data in addressable_rows(r_outs[2]):
        assert int(data.sum()) == 0

    layout = ("sub" if sdb.sub_blocks is not None
              else "wide" if sdb.payload_wide is not None else "bin")
    print(f"proc {pid} [{label}/{layout}]: OK ({n_checked} shards, "
          f"probe {t_probe:.1f}s, full step {t_step:.1f}s, "
          f"routed serve {t_serve:.1f}s)", flush=True)
    return n_checked


def main() -> int:
    pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    bench = "--bench" in sys.argv
    local_devices = int(os.environ.get("MP_LOCAL_DEVICES", "4"))
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={local_devices}")

    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(coordinator_address=f"127.0.0.1:{port}",
                               num_processes=nproc, process_id=pid)
    import numpy as np

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from close_kmers_tpu.parallel.multihost import replicate_to_global
    from close_kmers_tpu.parallel.sharding import make_mesh, probe_sharded
    from close_kmers_tpu.parallel.sharding import ShardedDB
    from close_kmers_tpu.core.engine import FastAnnotator
    from close_kmers_tpu.ops import encoder as E

    assert jax.process_count() == nproc, jax.process_count()
    n_global = nproc * local_devices

    mesh = make_mesh(n_data=2, n_table=n_global // 2)
    from jax.sharding import Mesh
    mesh_local = Mesh(
        np.array(jax.local_devices()[:1]).reshape(1, 1), ("data", "table"))

    midsize = None
    if "--midsize" in sys.argv:
        midsize = sys.argv[sys.argv.index("--midsize") + 1]

    if midsize is not None:
        # One cross-process case over a REAL mid-size DB
        # slice (>= 10M keys from the 208M scale build when present,
        # else a synthetic fallback), with deliberately uneven hi-space
        # occupancy (two disjoint key ranges), instead of the 30k-key toy.
        db3 = load_midsize(midsize)
        rng3 = np.random.default_rng(44)
        run_case(pid, mesh, mesh_local, db3, rng3, "midsize")
    else:
        rng = np.random.default_rng(42)
        db = build_db(rng, deep=False)
        run_case(pid, mesh, mesh_local, db, rng, "shallow")

        rng2 = np.random.default_rng(43)
        db2 = build_db(rng2, deep=True)
        run_case(pid, mesh, mesh_local, db2, rng2, "deep")

    if bench:
        keys = db.keys
        B, L = 64, 128
        seqs = []
        for i in range(B):
            frags = [E.decode_kmer(int(keys[rng.integers(0, len(keys))]))
                     for _ in range(rng.integers(1, 12))]
            seqs.append("".join(frags)[:L - 9])
        sdb = ShardedDB.from_db(db, mesh)
        fa = FastAnnotator(db)
        offsets, lengths = fa.pad_batch(seqs, pad_to=L)
        g_off, g_len = replicate_to_global(mesh, offsets,
                                           lengths.astype(np.int32))
        probe_sharded(sdb, g_off, g_len)  # warm
        reps = 5
        t0 = time.time()
        for _ in range(reps):
            out = probe_sharded(sdb, g_off, g_len)
        jax.block_until_ready(out[0])
        per = (time.time() - t0) / reps
        print(f"proc {pid}: {B / per:.0f} seqs/s/process "
              f"({per * 1e3:.1f} ms/step)", flush=True)

    print(f"proc {pid}: OK ({jax.process_count()} procs x "
          f"{local_devices} local devices)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
