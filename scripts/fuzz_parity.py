"""Randomized parity fuzzer: device pipeline vs the CPU oracle.

Each round builds a fresh random signature DB (random bucket shapes, so
all three probe layouts get exercised across rounds), generates
adversarial query sequences (fragment mosaics, ambiguity runs, repeats,
boundary lengths), sweeps EngineParams, and asserts byte-level equality
of hits, calls, OTU tallies, and best-calls between:

  * core.oracle.process_aa_seq (the reference-semantics ground truth)
  * the device probe + native C++ scorer (FastAnnotator path)
  * the on-device scan scorer (DeviceScorer packed calls)

Runs until --rounds (default 20) or first mismatch; prints a repro seed.
Usage: python scripts/fuzz_parity.py [--rounds N] [--device]

Runs on the CPU backend by default (the oracle comparison is the point,
and each round's new DB shapes recompile); --device fuzzes on the
default accelerator instead.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def one_round(seed: int) -> int:
    from close_kmers_tpu.core import oracle as O
    from close_kmers_tpu.core.device_score import DeviceScorer
    from close_kmers_tpu.core.engine import (FastAnnotator,
                                             DeviceEngine, finish_best_call)
    from close_kmers_tpu.db.signature_db import SignatureDB
    from close_kmers_tpu.native import api as native
    from close_kmers_tpu.ops import encoder as E
    from close_kmers_tpu.params import LO_CARD, EngineParams

    rng = np.random.default_rng(seed)
    # random DB shape: sometimes key-space-wide (shallow buckets ->
    # payload-wide layout), sometimes a narrow hi span (deep buckets ->
    # sub-bucket layout)
    deep = bool(rng.integers(0, 2))
    n = int(rng.integers(2_000, 40_000))
    if deep:
        h0 = int(rng.integers(0, 3_000_000))
        span = int(rng.integers(50, 2_000))
        his = rng.integers(h0, h0 + span, size=n, dtype=np.int64)
    else:
        his = rng.integers(0, 3_200_000, size=n, dtype=np.int64)
    keys = np.unique(his * LO_CARD + rng.integers(0, LO_CARD, size=n,
                                                  dtype=np.int64))
    n_funcs = int(rng.integers(2, 40))
    db = SignatureDB(
        keys,
        rng.integers(0, n_funcs, size=len(keys)).astype(np.int32),
        rng.integers(-1, 9, size=len(keys)).astype(np.int32),
        rng.integers(0, 500, size=len(keys)).astype(np.int32),
        rng.uniform(0.05, 6.0, size=len(keys)).astype(np.float32),
        functions=[f"fn{i}" for i in range(n_funcs)],
    )

    from close_kmers_tpu.ops.encoder import decode_kmer

    def rand_seq():
        parts = []
        total = 0
        target = int(rng.integers(0, 260))
        while total < target:
            r = rng.random()
            if r < 0.55:   # DB kmer fragments (possibly overlapping runs)
                k = decode_kmer(int(keys[rng.integers(0, len(keys))]))
                parts.append(k[:int(rng.integers(4, 9))])
            elif r < 0.8:
                parts.append("".join(rng.choice(list(E.PROT_ALPHA),
                                                size=int(rng.integers(1, 20)))))
            elif r < 0.9:
                parts.append("".join(rng.choice(list("XxUuBbZz*-"),
                                                size=int(rng.integers(1, 4)))))
            else:          # exact whole kmers back to back (dense runs)
                f = int(rng.integers(0, len(keys)))
                for q in range(int(rng.integers(1, 5))):
                    parts.append(decode_kmer(int(keys[min(f + q,
                                                          len(keys) - 1)])))
            total += len(parts[-1])
        return "".join(parts)

    seqs = [rand_seq() for _ in range(int(rng.integers(4, 24)))]
    seqs += ["", "A" * 8, "A" * 9, decode_kmer(int(keys[0])) * 3]

    params = EngineParams(
        min_hits=int(rng.integers(1, 7)),
        min_weighted_hits=int(rng.choice([0, 0, 1, 3])),
        max_gap=int(rng.choice([5, 30, 200, 1000])),
        order_constraint=int(rng.integers(0, 2)),
    )

    eng = DeviceEngine(db)
    mode = ("fused" if eng.ddb.fused_wide is not None else
            "sub" if eng.ddb.sub_blocks is not None else
            "wide" if eng.ddb.payload_wide is not None else "bin")
    fa = FastAnnotator(db)
    ds = DeviceScorer(db)

    # --- oracle ground truth
    want = []
    for s in seqs:
        calls, hits, otu = [], [], O.OtuStats()
        O.process_aa_seq(s, db.lookup, params, calls, hits.append, otu)
        otu.finalize()
        want.append((calls, hits, otu))

    # --- engine hits + replayed calls
    got = eng.process_batch([(f"s{i}", s) for i, s in enumerate(seqs)],
                            params, want_hits=True)
    for i, ((w_calls, w_hits, w_otu), (g_calls, g_hits, g_otu)) in \
            enumerate(zip(want, got)):
        assert len(g_hits) == len(w_hits), (i, "hits", mode)
        for a, b in zip(g_hits, w_hits):
            assert (a.pos, a.fI, a.oI, a.avg_off, a.code) == \
                (b.pos, b.fI, b.oI, b.avg_off, b.code), (i, mode)
            assert np.float32(a.wt) == np.float32(b.wt), (i, mode)
        assert [(c.start, c.end, c.count, c.fI) for c in g_calls] == \
            [(c.start, c.end, c.count, c.fI) for c in w_calls], (i, mode)
        for a, b in zip(g_calls, w_calls):
            assert np.float32(a.weighted) == np.float32(b.weighted), (i, mode)
        assert g_otu.otus_by_count == w_otu.otus_by_count, (i, mode)

    # --- device scan scorer (packed calls) + native best-call
    offsets, lengths = fa.pad_batch(seqs)
    n_calls, calls_l = ds.score_batch(offsets, lengths, params)
    for i, (w_calls, _h, _o) in enumerate(want):
        assert int(n_calls[i]) == len(w_calls), (i, "n_calls", mode)
        for a, b in zip(calls_l[i], w_calls):
            assert a[:4] == (b.start, b.end, b.count, b.fI), (i, mode)
            assert np.float32(a[4]) == np.float32(b.weighted), (i, mode)

    # --- best call: native reduction vs oracle find_best_call
    nb, cs, ce, cc, cf, cw, _v = native.score_batch(
        *[np.asarray(x) for x in _hit_arrays(fa, offsets, lengths)],
        params, 512, False)
    nf, ofi, ocnt, owt = native.best_call_batch(nb, cs, ce, cc, cf, cw)
    for i, (w_calls, _h, _o) in enumerate(want):
        w_best = O.find_best_call(w_calls, db.function_of)
        g_best = finish_best_call(int(nf[i]), ofi[i], ocnt[i], owt[i],
                                  db.function_of)
        assert (g_best.function, g_best.score, g_best.weighted_score,
                g_best.score_offset) == \
            (w_best.function, w_best.score, w_best.weighted_score,
             w_best.score_offset), (i, "best", mode)
    return len(seqs)


def _hit_arrays(fa, offsets, lengths):
    h = fa.probe_compact(offsets, lengths)
    return (h["pos"], h["fi"], h["oi"], h["avg_off"], h["wt"], h["row_off"])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--seed0", type=int, default=1000)
    ap.add_argument("--device", action="store_true",
                    help="fuzz on the default accelerator instead of CPU")
    args = ap.parse_args()
    if not args.device:
        os.environ["JAX_PLATFORMS"] = "cpu"
        import jax
        jax.config.update("jax_platforms", "cpu")
    t0 = time.time()
    total = 0
    for r in range(args.rounds):
        seed = args.seed0 + r
        try:
            total += one_round(seed)
        except AssertionError as e:
            print(f"MISMATCH at seed {seed}: {e}", flush=True)
            raise
        # every round compiles fresh shapes; drop the executables so a
        # long run doesn't exhaust host memory (observed ~290 rounds in)
        import jax
        jax.clear_caches()
        print(f"round {r} (seed {seed}) ok  [{time.time()-t0:.0f}s, "
              f"{total} seqs]", flush=True)
    print(f"all {args.rounds} rounds passed ({total} sequences)")


if __name__ == "__main__":
    main()
