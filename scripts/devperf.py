"""Device-resident stage decomposition of the fused annotation program.

Methodology: each measured program is wrapped so call i carries a
scalar dependence on call i-1 (true on-device serialization), a run of
K_HI calls and a run of K_LO calls are timed end-to-end including ONE
scalar readback each, and the per-call cost is (T_hi - T_lo) /
(K_HI - K_LO) — dispatch floors and readback latency cancel.  A
profiler trace is the better source of per-stage device time (ROADMAP
queue 1 #1); this harness stays until the bench reduces traces.

All DB arrays are passed as jit ARGUMENTS (never closure-captured:
captured device arrays embed as HLO constants).

Usage: python scripts/devperf.py [stage ...]
Stages: encode probe scan compact best family
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ.setdefault("BENCH_N_QUERY", "8192")
import bench  # noqa: E402  (reuses the corpus builder + cache)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from close_kmers_tpu.core.engine import (  # noqa: E402
    DeviceDB, encode_windows, probe_windows)
from close_kmers_tpu.core.device_score import (  # noqa: E402
    _scan_score, _best_call_device)
from close_kmers_tpu.params import EngineParams  # noqa: E402

K_HI = 12
K_LO = 4


def measure(name, fn, *args):
    """fn(carry, *args) -> f32 scalar carry.  Returns per-call seconds."""
    jfn = jax.jit(fn)

    def run(k):
        c = jnp.float32(0)
        t0 = time.time()
        for _ in range(k):
            c = jfn(c, *args)
        v = float(np.asarray(c))   # one scalar readback: the sync point
        return time.time() - t0, v

    t0 = time.time()
    run(2)  # compile + warm
    print(f"  [{name}: compile+warm {time.time()-t0:.1f}s]", flush=True)
    t_lo, _ = run(K_LO)
    t_hi, v = run(K_HI)
    per = (t_hi - t_lo) / (K_HI - K_LO)
    print(f"{name:28s} {per*1000:8.2f} ms/batch   (check {v:.3g})",
          flush=True)
    return per


PARAMS = EngineParams()


WIDE_W = 0  # set in main() from the DeviceDB (static: used for slicing)
SUB_W = 0


def _ddb_args(ddb):
    return (ddb.bucket_pair, ddb.lo, ddb.payload, ddb.lo_wide,
            ddb.payload_wide, ddb.sub_header, ddb.sub_blocks)


def _probe(ddb_arrs, n, n_steps, off, ln):
    bp, lo_a, pay, lw, pw, sh, sb = ddb_arrs
    ddb = DeviceDB(bp, lo_a, pay, n_steps, n, lw, pw, WIDE_W, sh, sb,
                   SUB_W)
    hi, lo, valid = encode_windows(off, ln)
    return probe_windows(ddb, hi, lo, valid)


def stage_encode(c, ddb_arrs, n, n_steps, off, ln):
    hi, lo, valid = encode_windows(off, ln)
    return c + (hi * 3 + lo).sum().astype(jnp.float32) + \
        valid.sum().astype(jnp.float32)


def stage_probe(c, ddb_arrs, n, n_steps, off, ln):
    found, fi, oi, av, wt, idx = _probe(ddb_arrs, n, n_steps, off, ln)
    return c + fi.sum().astype(jnp.float32) + wt.sum() + \
        found.sum().astype(jnp.float32)


def make_stage_probe_raw(hi_d, lo_d, valid_d):
    """Probe fed pre-staged (hi, lo, valid) device arrays — isolates the
    gather+selection from the encode/where preprocessing."""
    def stage_probe_raw(c, ddb_arrs, n, n_steps, off, ln):
        bp, lo_a, pay, lw, pw, sh, sb = ddb_arrs
        ddb = DeviceDB(bp, lo_a, pay, n_steps, n, lw, pw, WIDE_W, sh, sb,
                       SUB_W)
        found, fi, oi, av, wt, idx = probe_windows(ddb, hi_d, lo_d, valid_d)
        return c + fi.sum().astype(jnp.float32) + wt.sum() + \
            found.sum().astype(jnp.float32)
    return stage_probe_raw


def stage_scan(c, ddb_arrs, n, n_steps, off, ln):
    found, fi, oi, av, wt, idx = _probe(ddb_arrs, n, n_steps, off, ln)
    emit, fields = _scan_score(found, fi, av, wt, PARAMS.min_hits,
                               PARAMS.min_weighted_hits, PARAMS.max_gap,
                               PARAMS.order_constraint)
    return c + emit.sum().astype(jnp.float32) + fields[4].sum()


def stage_compact(c, ddb_arrs, n, n_steps, off, ln):
    found, fi, oi, av, wt, idx = _probe(ddb_arrs, n, n_steps, off, ln)
    emit, fields = _scan_score(found, fi, av, wt, PARAMS.min_hits,
                               PARAMS.min_weighted_hits, PARAMS.max_gap,
                               PARAMS.order_constraint)
    CAP = emit.shape[0] * 2
    flat = emit.reshape(-1)
    order = jnp.argsort(~flat, stable=True)[:CAP]
    tot = jnp.float32(0)
    for f in fields[:4]:
        tot = tot + f.reshape(-1)[order].sum().astype(jnp.float32)
    return c + tot


def stage_best(c, ddb_arrs, n, n_steps, off, ln):
    found, fi, oi, av, wt, idx = _probe(ddb_arrs, n, n_steps, off, ln)
    emit, (cs, ce, cc, cf, cw) = _scan_score(
        found, fi, av, wt, PARAMS.min_hits, PARAMS.min_weighted_hits,
        PARAMS.max_gap, PARAMS.order_constraint)
    out = _best_call_device(emit, cc, cf, cw)
    return c + out[0].sum().astype(jnp.float32) + \
        out[2].sum().astype(jnp.float32)


def main():
    which = set(sys.argv[1:]) or {
        "encode", "probe", "scan", "compact", "best"}
    from close_kmers_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()

    rng = np.random.default_rng(0)
    db, offsets, lengths = bench.build_corpus(rng)
    B = bench.BATCH
    offsets = offsets[:B]
    lengths = lengths[:B]
    ddb = DeviceDB.from_db(db)
    global WIDE_W, SUB_W
    WIDE_W = ddb.wide_w
    SUB_W = ddb.sub_w
    arrs = _ddb_args(ddb)
    d_off = jax.device_put(jnp.asarray(offsets))
    d_len = jax.device_put(jnp.asarray(lengths))
    print(f"B={B} L={offsets.shape[1]} W={offsets.shape[1]-8} "
          f"DB={len(db):,} max_bucket={db.max_bucket}", flush=True)

    stages = dict(encode=stage_encode, probe=stage_probe, scan=stage_scan,
                  compact=stage_compact, best=stage_best)
    if "probe_raw" in which:
        hi0, lo0, valid0 = encode_windows(d_off, d_len)
        hi_d = jax.device_put(np.asarray(hi0))
        lo_d = jax.device_put(np.asarray(lo0))
        valid_d = jax.device_put(np.asarray(valid0))
        stages["probe_raw"] = make_stage_probe_raw(hi_d, lo_d, valid_d)

    fam_args = None
    if "family" in which:
        from close_kmers_tpu.core.device_family import (
            _family_rollup_jit, DeviceFamilyDB)
        from close_kmers_tpu.db.family_db import KmerFamilyMapping
        n = len(db)
        deg = rng.integers(1, 4, size=n)
        offs2 = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(deg, out=offs2[1:])
        vals = np.repeat(db.fi * 3, deg) + (
            np.arange(offs2[-1]) % 3).astype(np.int32)
        mapping = KmerFamilyMapping()
        mapping._fam_csr = (db.keys, offs2, vals.astype(np.int32))
        fdb = DeviceFamilyDB.from_mapping(db, mapping)

        def stage_family(c, fam_tab, bp, lo_a, pay, lw, pw, sh, sb,
                         off, ln):
            out = _family_rollup_jit(bp, lo_a, pay, len(db), ddb.n_steps,
                                     fam_tab, off, ln, 8, lw, pw, WIDE_W,
                                     sh, sb, SUB_W)
            return c + out[:B].sum().astype(jnp.float32)

        stages["family"] = stage_family
        fam_args = (fdb.fam,) + arrs

    if which & {"fam_global", "fam_serve", "fam_serve_h",
                "fam_serve_rows", "fam_serve_fw", "fam_gather"}:
        # the exact serving programs (api.best_family_matches_padded):
        # fused calls+rollup, slim calls, global vs per-row compaction
        from close_kmers_tpu.core.device_family import (
            _family_rollup_jit, _score_family_jit, _gather_fams,
            DeviceFamilyDB)
        from close_kmers_tpu.db.family_db import KmerFamilyMapping
        n = len(db)
        deg = rng.integers(1, 4, size=n)
        offs2 = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(deg, out=offs2[1:])
        vals = np.repeat(db.fi * 3, deg) + (
            np.arange(offs2[-1]) % 3).astype(np.int32)
        mapping = KmerFamilyMapping()
        mapping._fam_csr = (db.keys, offs2, vals.astype(np.int32))
        fdb = DeviceFamilyDB.from_mapping(db, mapping)

        fw_tab = fam_w = fam_d = None
        if "fam_serve_fw" in which:
            fw_tab, fam_w, fam_d = DeviceFamilyDB.famwide_from_mapping(
                db, mapping, force=True)

        def mk(kind):
            def stage(c, fam_tab, bp, lo_a, pay, lw, pw, sh, sb, off, ln):
                if kind == "serve_fw":
                    # fam_tab slot carries the FOLDED table (jit ARG, not
                    # a closure capture — captured arrays would embed
                    # GB of HLO constants); the unused fam_tab jit param
                    # gets a small dummy.
                    calls_out, rows = _score_family_jit(
                        bp, lo_a, pay, len(db), ddb.n_steps, pay,
                        off, ln, PARAMS.min_hits, PARAMS.min_weighted_hits,
                        PARAMS.max_gap, PARAMS.order_constraint, B, -2 * B,
                        lw, pw, WIDE_W, sh, sb, SUB_W, None, 0, True, 0,
                        fam_tab, fam_w, fam_d)
                    return (c + calls_out[:B].sum().astype(jnp.float32)
                            + rows.reshape(-1)[:B].sum().astype(jnp.float32))
                if kind == "gather":
                    ddb2 = DeviceDB(bp, lo_a, pay, ddb.n_steps, len(db),
                                    lw, pw, WIDE_W, sh, sb, SUB_W)
                    hi, lo, valid = encode_windows(off, ln)
                    *_, idx = probe_windows(ddb2, hi, lo, valid)
                    fams = _gather_fams(fam_tab, idx)
                    return c + fams.sum().astype(jnp.float32)
                if kind == "global":
                    out = _family_rollup_jit(
                        bp, lo_a, pay, len(db), ddb.n_steps, fam_tab,
                        off, ln, -2 * B, lw, pw, WIDE_W, sh, sb, SUB_W)
                    return c + out[:B].sum().astype(jnp.float32)
                cap = 8 if kind == "rows" else -2 * B
                rcap = 32 if kind == "serve_h" else 0
                calls_out, rows = _score_family_jit(
                    bp, lo_a, pay, len(db), ddb.n_steps, fam_tab, off, ln,
                    PARAMS.min_hits, PARAMS.min_weighted_hits,
                    PARAMS.max_gap, PARAMS.order_constraint, B, cap,
                    lw, pw, WIDE_W, sh, sb, SUB_W, None, 0, True, rcap)
                return (c + calls_out[:B].sum().astype(jnp.float32)
                        + rows.reshape(-1)[:B].sum().astype(jnp.float32))
            return stage

        stages["fam_gather"] = mk("gather")
        stages["fam_global"] = mk("global")
        stages["fam_serve"] = mk("serve")
        stages["fam_serve_h"] = mk("serve_h")
        stages["fam_serve_rows"] = mk("rows")
        stages["fam_serve_fw"] = mk("serve_fw")
        fam_args = (fdb.fam,) + arrs

    results = {}
    for name in ("encode", "probe", "probe_raw", "scan", "compact", "best",
                 "family", "fam_gather", "fam_global",
                 "fam_serve_rows", "fam_serve", "fam_serve_h",
                 "fam_serve_fw"):
        if name in which and name in stages:
            if name == "fam_serve_fw":
                results[name] = measure(name, stages[name],
                                        fw_tab, *fam_args[1:], d_off, d_len)
            elif name.startswith("fam"):
                results[name] = measure(name, stages[name],
                                        *fam_args, d_off, d_len)
            else:
                results[name] = measure(name, stages[name], arrs,
                                        len(db), ddb.n_steps, d_off, d_len)
    prev = 0.0
    print("--- increments ---")
    for name in ("encode", "probe", "scan", "compact"):
        if name in results:
            print(f"{name:28s} +{(results[name]-prev)*1000:8.2f} ms")
            prev = results[name]


if __name__ == "__main__":
    main()
