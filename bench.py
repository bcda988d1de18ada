"""Benchmark: proteins/s through the full annotation pipeline on one GPU.

Workload (BASELINE.json config 2 analogue): a synthetic signature DB built
from source proteins, then batch annotation of query proteins — device
window-encode + two-level probe, native C++ run/gap scoring + best-call
reduction.  Baseline = the same pipeline on one CPU core through the
native single-core engine (ck_pipeline_batch), standing in for the
reference's one-thread-per-request design (threadpool.cc:18-45; the
reference itself needs boost/TBB not present in this image).

Prints the device line (card name and power limit, JAX platform, kind
and count), then exactly ONE JSON line on stdout.  Fails when JAX finds
no GPU, and exits nonzero after the JSON when any section raised.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

N_SRC = int(os.environ.get("BENCH_N_SRC", 70_000))     # source proteins
PROT_LEN = int(os.environ.get("BENCH_PROT_LEN", 300))
N_QUERY = int(os.environ.get("BENCH_N_QUERY", 65_536))  # queries per pass
BATCH = int(os.environ.get("BENCH_BATCH", 4096))
N_CPU = int(os.environ.get("BENCH_N_CPU", 16384))      # baseline sample (large enough to exceed LLC)
CALL_CAP = float(os.environ.get("BENCH_CALL_CAP", 1.3))  # calls/seq download cap
PASSES = int(os.environ.get("BENCH_PASSES", 8))        # best-of-N passes
N_FUNCS = 4096
CACHE = os.environ.get(
    "BENCH_CACHE",
    os.path.join(os.path.dirname(os.path.abspath(__file__)), ".bench_cache"))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def source_corpus(rng, n_src=N_SRC, prot_len=PROT_LEN, n_funcs=N_FUNCS):
    """Uniform random source proteins and their signature kmers: returns
    (keys int64 sorted unique, fi int32, off uint8[n_src, prot_len]).
    Source protein i carries function i % n_funcs; a kmer shared by
    several proteins keeps its first protein's function."""
    off = rng.integers(0, 20, size=(n_src, prot_len), dtype=np.int64
                       ).astype(np.uint8)
    W = prot_len - 8 + 1
    o32 = off.astype(np.int32)
    hi = np.zeros((n_src, W), dtype=np.int32)
    lo = np.zeros((n_src, W), dtype=np.int32)
    for j in range(4):
        hi = hi * 20 + o32[:, j:j + W]
        lo = lo * 20 + o32[:, 4 + j:4 + j + W]
    keys = (hi.astype(np.int64) * 160000 + lo).ravel()
    fi = np.repeat(np.arange(n_src, dtype=np.int64) % n_funcs, W)
    keys, idx = np.unique(keys, return_index=True)
    return keys, fi[idx].astype(np.int32), off


def corpus_db(keys, fi, rng, functions=None):
    """SignatureDB over the corpus kmers with payload planes (oi,
    avg_off, wt) drawn from ``rng``."""
    from close_kmers_tpu.db.signature_db import SignatureDB
    return SignatureDB(
        keys, fi,
        rng.integers(-1, 64, size=len(keys)).astype(np.int32),
        rng.integers(0, PROT_LEN, size=len(keys)).astype(np.int32),
        rng.uniform(0.1, 4.0, size=len(keys)).astype(np.float32),
        functions=functions)


def build_corpus(rng):
    os.makedirs(CACHE, exist_ok=True)
    tag = f"{N_SRC}x{PROT_LEN}"
    cache_file = os.path.join(CACHE, f"corpus_{tag}.npz")
    t0 = time.time()
    if os.path.exists(cache_file):
        z = np.load(cache_file)
        keys, fi, off = z["keys"], z["fi"], z["off"]
        log(f"corpus loaded from cache in {time.time()-t0:.1f}s")
    else:
        keys, fi, off = source_corpus(rng)
        np.savez(cache_file, keys=keys, fi=fi, off=off)
        log(f"corpus built in {time.time()-t0:.1f}s")

    # Payload and query draws come from a FRESH stream: after a cache
    # hit the caller's rng sits at a different position than after a
    # fresh build, and reusing it made benchmark inputs depend on
    # whether .bench_cache existed.
    rng = np.random.default_rng(len(keys))
    t0 = time.time()
    db = corpus_db(keys, fi, rng)
    log(f"DB: {len(db):,} kmers, max bucket {db.max_bucket}, "
        f"indexed in {time.time()-t0:.1f}s")

    # queries: slices of source proteins (dense-hit regime)
    qi = rng.integers(0, N_SRC, size=N_QUERY)
    width = -(-(PROT_LEN + 8) // 8) * 8   # multiple of 8 for 5-bit packing
    offsets = np.full((N_QUERY, width), 20, dtype=np.uint8)
    offsets[:, :PROT_LEN] = off[qi]
    lengths = np.full(N_QUERY, PROT_LEN, dtype=np.int32)
    return db, offsets, lengths


def bench_device(db, offsets, lengths):
    """Device probe + scan scoring (compact CALL download) + native C++
    best-call reduction, with grouped readback pipelining.  (The fully
    fused device find_best_call path, DeviceScorer.best_batch_packed,
    is the alternative: a smaller download for extra reduction scans.)"""
    from close_kmers_tpu.core.device_score import DeviceScorer
    from close_kmers_tpu.native import api as native
    from close_kmers_tpu.params import EngineParams

    ds = DeviceScorer(db)
    params = EngineParams()
    # best-call serving never reads call positions: the slim pack drops
    # the start/end planes (5 -> 2-3 D2H planes)
    slim = ds.slim_mode()
    unpack = (DeviceScorer.unpack_dense2 if slim == 2
              else DeviceScorer.unpack_dense3)

    def host_side(out_np, B, cap):
        dense = unpack(out_np, B, cap)
        assert dense is not None, "call cap overflow"
        n_calls, cc, cf, cw = dense
        nf, ofi, ocnt, owt = native.best_call_batch(n_calls, None, None,
                                                    cc, cf, cw)
        return int(n_calls.sum())

    import jax
    import jax.numpy as jnp
    GROUP = int(os.environ.get("BENCH_GROUP", 16))

    # Pre-slice contiguous batches (the server's parser hands over
    # contiguous padded arrays the same way).
    chunks = [np.ascontiguousarray(offsets[a:a + BATCH])
              for a in range(0, N_QUERY - BATCH + 1, BATCH)]
    lens_b = np.ascontiguousarray(lengths[:BATCH])

    # warmup/compile
    t0 = time.time()
    out, cap = ds.score_batch_packed(chunks[0], lens_b, params,
                                     calls_per_seq_cap=CALL_CAP, slim=slim)
    host_side(np.asarray(out), BATCH, cap)
    jax.block_until_ready(jnp.concatenate([out] * min(GROUP, len(chunks))))
    log(f"warmup+compile {time.time()-t0:.1f}s")

    def one_pass():
        """Dispatch-ahead serving loop: enqueue EVERY batch up front —
        uploads and computes chain on the device while the Python thread
        never blocks — with each GROUP's device concat dispatched EAGERLY
        (the device runs programs in dispatch order, so a concat enqueued
        during the drain loop would wait for every later batch; enqueued
        here it runs right after its group and its D2H overlaps later
        groups' compute).  One D2H per group."""
        t0 = time.time()
        outs = []
        joins = []
        for c in chunks:
            out, cap = ds.score_batch_packed(c, lens_b, params,
                                             calls_per_seq_cap=CALL_CAP,
                                             slim=slim)
            outs.append(out)
            if len(outs) >= GROUP:
                joins.append((jnp.concatenate(outs), len(outs)))
                outs = []
        if outs:
            joins.append((jnp.concatenate(outs)
                          if len(outs) > 1 else outs[0], len(outs)))
        total_calls = n_done = 0
        n = BATCH + slim * cap
        for j, cnt in joins:
            joined = np.asarray(j)
            k = 0
            for _ in range(cnt):
                total_calls += host_side(joined[k:k + n], BATCH, cap)
                n_done += BATCH
                k += n
        dt = time.time() - t0
        return n_done, dt, total_calls

    best = None
    for p in range(PASSES):
        n_done, dt, total_calls = one_pass()
        log(f"device pass {p}: {n_done} proteins in {dt:.2f}s, "
            f"{total_calls} calls")
        if best is None or dt / n_done < best[1] / best[0]:
            best = (n_done, dt)
    return best[0] / best[1], ds, one_pass


def bench_device_resident(ds, offsets, lengths):
    """Chained scalar-dependence rate of the fused probe+scan+compact
    program (scripts/devperf.py methodology): call i carries a scalar
    dependence on call i-1, floors cancel in the (hi-lo)-run difference.
    This is the device-side rate with host work taken out; the artifact
    records it beside the end-to-end rate."""
    import contextlib
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "scripts"))
    import devperf
    import jax.numpy as jnp
    d = ds.ddb
    devperf.WIDE_W = d.wide_w
    devperf.SUB_W = d.sub_w
    RB = max(BATCH, 8192)   # resident rate is measured at the 8k shape
    with contextlib.redirect_stdout(sys.stderr):
        per = devperf.measure(
            "device-resident probe+scan+compact", devperf.stage_compact,
            devperf._ddb_args(d), d.n, d.n_steps,
            jnp.asarray(offsets[:RB]), jnp.asarray(lengths[:RB]))
    rate = RB / per
    log(f"device-resident (chained): {rate:.0f} proteins/s "
        f"({per*1e3:.1f} ms / {RB})")
    return rate


def bench_cpu(db, offsets, lengths):
    """Single-core baselines: (a) the reference-architecture open-addressed
    hash (kguts layout — this is vs_baseline), (b) our sorted two-level
    index on CPU (stderr only)."""
    from close_kmers_tpu.native import api as native

    t0 = time.time()
    hp = native.HashPipeline(db)
    log(f"hash table built: {hp.size_hash:,} buckets in {time.time()-t0:.1f}s")
    best = None
    for _ in range(3):  # best-of-3: the shared host is noisy
        t0 = time.time()
        n_calls = hp.run(offsets[:N_CPU], lengths[:N_CPU])
        dt = time.time() - t0
        best = dt if best is None else min(best, dt)
    log(f"CPU single-core (reference hash layout): {N_CPU} proteins in "
        f"{best:.2f}s best-of-3 ({int(n_calls.sum())} calls)")

    t0 = time.time()
    native.pipeline_batch(db, offsets[:N_CPU], lengths[:N_CPU])
    log(f"CPU single-core (sorted two-level): {N_CPU} proteins in "
        f"{time.time()-t0:.2f}s")
    return N_CPU / best, hp


def make_family_universe(db, rng):
    """Named-function DB + synthetic family universe (deg 1-3 kmer->fam
    CSR, 3 families per function) shared by the family/fastq workloads."""
    from close_kmers_tpu.db.family_db import FamilyData, KmerFamilyMapping
    from close_kmers_tpu.db.signature_db import SignatureDB

    n_funcs = int(db.fi.max()) + 1
    dbf = SignatureDB(db.keys, db.fi, db.oi, db.avg_off, db.wt,
                      functions=[f"fn{i}" for i in range(n_funcs)])
    n = len(dbf)
    deg = rng.integers(1, 4, size=n)
    offs = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(deg, out=offs[1:])
    vals = np.repeat(dbf.fi * 3, deg) + (np.arange(offs[-1]) % 3).astype(np.int32)
    mapping = KmerFamilyMapping()
    mapping._fam_csr = (dbf.keys, offs, vals.astype(np.int32))
    mapping.families = [
        FamilyData(f"PGF_{f:08d}", f"PLF_{f % 5}_{f:08d}", f % 5,
                   f"fn{f // 3}", f, 10, 10) for f in range(3 * n_funcs)]
    return dbf, mapping


def bench_family(eng, mapping, offsets, lengths):
    """The full /lookup?find_best_match=1 serving path — fused device
    calls+rollup, global packs, grouped-readback pipelining, vectorized
    best-match scan.  Measures the ARRAY path (pre-padded batch, as the
    server pads once from parsed FASTA), so per-item list construction
    in the bench does not count against the serving path."""
    from close_kmers_tpu.core.api import KmerEngine

    off_q = offsets[:N_QUERY]
    len_q = lengths[:N_QUERY]
    t0 = time.time()
    # warm the REAL serving chunk shape: a smaller warmup batch would
    # compile its own (useless) B
    eng.best_family_matches_padded(
        off_q[:KmerEngine.FAMILY_MATCH_CHUNK],
        len_q[:KmerEngine.FAMILY_MATCH_CHUNK], mapping)
    log(f"family warmup+compile {time.time()-t0:.1f}s")
    def fam_pass():
        t0 = time.time()
        ms = eng.best_family_matches_padded(off_q, len_q, mapping)
        return ms, time.time() - t0

    best = None
    for _ in range(PASSES):
        ms, dt = fam_pass()
        best = dt if best is None else min(best, dt)
    n_called = sum(1 for m in ms if m.gfam_id)
    rate = len(ms) / best
    log(f"family best-match path: {len(ms)} proteins in {best:.2f}s "
        f"best-of-{PASSES} ({rate:.0f} proteins/s, {n_called} placed)")
    return rate, fam_pass


def bench_fastq(eng, mapping, offsets):
    """/fq_lookup workload (BASELINE config 3): FASTQ reads -> 6-frame
    ORFs > 10aa -> best family match per ORF -> best frame per read."""
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "scripts"))
    from fq_bench import synth_reads
    from close_kmers_tpu.ops.translate import batch_orf_arrays

    rng = np.random.default_rng(3)
    n_reads = int(os.environ.get("BENCH_FQ_READS", 20_000))
    reads = synth_reads(rng, offsets[:2048, :PROT_LEN], n_reads, 150)

    def one_pass():
        t0 = time.time()
        ofs, lens, toks = batch_orf_arrays([seq for _, seq in reads])
        matches = eng.best_family_matches_padded(
            ofs, lens, mapping, kmer_hit_threshold=3, genus_filter=False,
            as_arrays=True)
        scores = np.where(matches.gfam_score > 0, matches.score,
                          0.0).astype(np.float64)
        tok_score = np.where(toks["orf"] >= 0, scores[toks["orf"]], 0.0)
        totals = np.zeros((n_reads, 6), dtype=np.float64)
        np.add.at(totals, (toks["read"], toks["fpos"].astype(np.int64)),
                  tok_score)
        return time.time() - t0, int((totals.max(axis=1) > 0).sum())

    one_pass()  # warm (ORF chunk shapes)
    best = None
    for _ in range(8):
        dt, n_called = one_pass()
        best = dt if best is None else min(best, dt)
    rate = n_reads / best
    log(f"fastq path: {n_reads} reads in {best:.2f}s best-of-8 "
        f"({rate:.0f} reads/s, {n_called} called)")
    return rate


def bench_genome(eng, offsets, hp):
    """Whole-genome workload (BASELINE config 2 input shape): the
    device-resident process_seq program (core/genome.py — on-chip
    6-frame translate + tiled carry-threaded scoring, only the call
    pack crossing the wire); CPU ref = the same frames through the
    reference-layout hash core."""
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "scripts"))
    from dna_bench import synth_genome
    from close_kmers_tpu.core.genome import GenomeAnnotator
    from close_kmers_tpu.ops.translate import six_frame_kguts_offsets
    from close_kmers_tpu.params import EngineParams

    rng = np.random.default_rng(4)
    n_bases = int(float(os.environ.get("BENCH_GENOME_MBP", 5)) * 1e6)
    genome = synth_genome(rng, offsets[:, :PROT_LEN], n_bases)
    params = EngineParams()
    ga = GenomeAnnotator(eng)
    from close_kmers_tpu.ops.translate import _DNA_CHAR, _to_bytes
    digits = _DNA_CHAR[_to_bytes(genome)]  # parse once, like the server

    def one_pass():
        t0 = time.time()
        per_frame, _frames = ga.calls_of(digits, params)
        return time.time() - t0, int(per_frame.sum())

    one_pass()
    best = None
    for _ in range(6):
        dt, n_calls = one_pass()
        best = dt if best is None else min(best, dt)
    rate = len(genome) / best / 1e6
    log(f"genome path: {len(genome):,} bp in {best:.2f}s best-of-6 "
        f"({rate:.2f} Mbp/s, {n_calls} calls)")

    # chained throughput (genome-stream serving): dispatch k programs
    # back-to-back (device executes serially), difference k=4 vs k=1 to
    # cancel the per-pass dispatch+D2H floors — the multi-contig
    # serving rate, like query's device-resident line
    def chained(k):
        t0 = time.time()
        outs = [ga.dispatch(digits, params)[0] for _ in range(k)]
        np.asarray(outs[-1][:8])
        return time.time() - t0

    chained(1)
    per = (chained(4) - chained(1)) / 3
    chain_rate = len(genome) / per / 1e6
    log(f"genome chained (stream): {chain_rate:.2f} Mbp/s "
        f"({per*1e3:.0f} ms/genome)")

    cpu_rate = None
    if hp is not None:
        frames = six_frame_kguts_offsets(genome)
        L = max(len(p) for _s, _o, p in frames)
        stride = -(-(L + 1) // 8) * 8
        fr_off = np.full((len(frames), stride), 20, dtype=np.uint8)
        fr_len = np.zeros(len(frames), dtype=np.int32)
        for i, (_s, _o, p) in enumerate(frames):
            fr_off[i, :len(p)] = p
            fr_len[i] = len(p)
        best_c = None
        for _ in range(2):
            t0 = time.time()
            hp.run(fr_off, fr_len)
            dt = time.time() - t0
            best_c = dt if best_c is None else min(best_c, dt)
        cpu_rate = len(genome) / best_c / 1e6
        log(f"genome CPU core (reference hash): {cpu_rate:.2f} Mbp/s")
    return rate, cpu_rate, chain_rate


def bench_matrix(eng, offsets, lengths, rng, hp=None):
    """/matrix workload (BASELINE config 4): all-vs-all shared-kmer
    counts over one request's proteins.  Device side = the device-resident
    pair program (core/matrix.py: probe + CSR peg gathers + rank filter
    + pair sort/run-length, only the compacted pair table crossing the
    wire); CPU side = the reference architecture on one core — hash
    probe + per-hit peg-list walk + std::map pair counts
    (matrix_request.cc:83-161, its O(P^2)-pair design) over the same
    proteins, same run."""
    from close_kmers_tpu.core.matrix import DeviceMatrix
    from close_kmers_tpu.native import api as native

    P = int(os.environ.get("BENCH_MATRIX_P", 2048))
    off_m, len_m = offsets[:P], lengths[:P]
    # deg-1..3 kmer->peg CSR over the DB; peg ids land in [0, 2P) so
    # roughly half of every hit's peg list points at registered matrix
    # proteins (eid = row) — realistic pair densities for the loop
    db = eng.db
    n = len(db)
    deg = rng.integers(1, 4, size=n)
    offs = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(deg, out=offs[1:])
    vals = ((np.repeat(db.fi.astype(np.int64) * 3, deg)
             + (np.arange(offs[-1]) % 3)) % (2 * P)).astype(np.int64)
    rank = np.full(2 * P, 1 << 20, dtype=np.int64)
    rank[:P] = np.arange(P)   # eid == registration order == row
    dm = DeviceMatrix(eng, max_deg=3)

    def one_pass():
        t0 = time.time()
        pairs = dm.count_pairs(off_m, len_m, offs, vals, rank)
        return time.time() - t0, len(pairs), sum(pairs.values())

    one_pass()
    best = None
    for _ in range(3):
        dt, n_pairs, shared = one_pass()
        best = dt if best is None else min(best, dt)
    rate = P / best
    log(f"matrix path: {P} proteins in {best:.2f}s best-of-3 "
        f"({rate:.0f} proteins/s, {n_pairs} pairs)")

    cpu_rate = None
    if hp is not None:
        pm = native.PegMapRef(db.keys, offs, vals)  # preload, untimed
        best_c = None
        for _ in range(2):
            t0 = time.time()
            n_pairs_c, shared_c = native.matrix_hash(hp, pm, off_m, len_m)
            dt = time.time() - t0
            best_c = dt if best_c is None else min(best_c, dt)
        assert (n_pairs_c, shared_c) == (n_pairs, shared), (
            "matrix CPU/device disagree", n_pairs_c, n_pairs, shared_c, shared)
        cpu_rate = P / best_c
        log(f"matrix CPU core (reference hash + map walk): "
            f"{cpu_rate:.0f} proteins/s ({n_pairs_c} pairs)")
    return rate, cpu_rate


def device_line(jax) -> dict:
    """The card's name and power limit (nvidia-smi) and the device as
    JAX reports it; raises when JAX finds no GPU."""
    import subprocess
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"bench.py needs a GPU; JAX found "
                         f"{devs[0].platform} devices only")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(smi, flush=True)
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def main():
    import jax
    from close_kmers_tpu.utils.compile_cache import enable_compile_cache
    device = device_line(jax)
    enable_compile_cache()
    failed = []
    rng = np.random.default_rng(0)
    db, offsets, lengths = build_corpus(rng)
    cpu_rate, hp = bench_cpu(db, offsets, lengths)
    dev_rate, ds, query_pass = bench_device(db, offsets, lengths)

    # Per-workload artifact: every BASELINE workload in one JSON.
    # Sections are env-gated; a section that raises is logged, named in
    # "failed", and makes the run exit nonzero.
    workloads = {"query": {"proteins_per_s": round(dev_rate, 1),
                           "cpu_core_proteins_per_s": round(cpu_rate, 1)}}
    if os.environ.get("BENCH_RESIDENT", "1") == "1":
        try:
            dev = bench_device_resident(ds, offsets, lengths)
            workloads["query"]["device_resident_proteins_per_s"] = \
                round(dev, 1)
        except Exception as e:
            log("device-resident bench failed:", e)
            failed.append("device_resident")
    eng = mapping = None
    try:
        from close_kmers_tpu.core.api import KmerEngine
        dbf, mapping = make_family_universe(db, rng)
        eng = KmerEngine(dbf)
    except Exception as e:
        log("engine setup failed:", e)
        failed.append("engine_setup")
    if eng is not None and os.environ.get("BENCH_FAMILY", "1") == "1":
        try:
            fam, fam_pass = bench_family(eng, mapping, offsets, lengths)
            workloads["family_best_match"] = {
                "proteins_per_s": round(fam, 1)}
            # family/query ratio measured on INTERLEAVED passes, so
            # each adjacent pair shares the same machine state.
            if os.environ.get("BENCH_RATIO", "1") == "1":
                ratios = []
                for _ in range(5):
                    nq, dtq, _ = query_pass()
                    _ms, dtf = fam_pass()
                    ratios.append((N_QUERY / dtf) / (nq / dtq))
                    # these are real serving passes: fold them into the
                    # best-of-N rates (both sides, same rule)
                    fam = max(fam, N_QUERY / dtf)
                workloads["family_best_match"]["proteins_per_s"] = \
                    round(fam, 1)
                ratios.sort()
                med = ratios[len(ratios) // 2]
                log(f"interleaved family/query ratios: "
                    f"{[f'{r:.2f}' for r in ratios]} -> median {med:.3f}")
                workloads["family_best_match"]["interleaved_ratio"] = \
                    round(med, 3)
        except Exception as e:
            log("family bench failed:", e)
            failed.append("family_best_match")
    if eng is not None and os.environ.get("BENCH_FASTQ", "1") == "1":
        try:
            fq = bench_fastq(eng, mapping, offsets)
            workloads["fastq"] = {"reads_per_s": round(fq, 1)}
        except Exception as e:
            log("fastq bench failed:", e)
            failed.append("fastq")
    if eng is not None and os.environ.get("BENCH_GENOME", "1") == "1":
        try:
            mbp, cpu_mbp, chain_mbp = bench_genome(eng, offsets, hp)
            workloads["genome"] = {"mbp_per_s": round(mbp, 2),
                                   "chained_mbp_per_s": round(chain_mbp, 2)}
            if cpu_mbp is not None:
                workloads["genome"]["cpu_core_mbp_per_s"] = round(cpu_mbp, 2)
        except Exception as e:
            log("genome bench failed:", e)
            failed.append("genome")
    if eng is not None and os.environ.get("BENCH_MATRIX", "1") == "1":
        try:
            mx, mx_cpu = bench_matrix(eng, offsets, lengths, rng, hp)
            workloads["matrix"] = {"proteins_per_s": round(mx, 1)}
            if mx_cpu is not None:
                workloads["matrix"]["cpu_core_proteins_per_s"] = \
                    round(mx_cpu, 1)
        except Exception as e:
            log("matrix bench failed:", e)
            failed.append("matrix")

    # Second query sample at the END of the run (the sampling rework is
    # ROADMAP queue 1 #1).
    try:
        for _ in range(max(2, PASSES // 2)):
            n_done, dt, _ = query_pass()
            rate2 = n_done / dt
            log(f"device pass (resample): {n_done} proteins in {dt:.2f}s")
            if rate2 > dev_rate:
                dev_rate = rate2
        workloads["query"]["proteins_per_s"] = round(dev_rate, 1)
    except Exception as e:
        log("query resample failed:", e)
        failed.append("query_resample")

    print(json.dumps({
        "metric": "proteins_per_s_per_chip",
        "value": round(dev_rate, 1),
        "unit": "proteins/s",
        "vs_baseline": round(dev_rate / cpu_rate, 2),
        "workloads": workloads,
        "device": device,
        "failed": failed,
    }))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
