"""Device engine vs CPU oracle parity: encode+probe positions, payloads,
and full call/OTU outputs must match exactly."""

import numpy as np
import pytest

from close_kmers_tpu.params import EngineParams, K
from close_kmers_tpu.ops import encoder as E
from close_kmers_tpu.core import oracle as O
from close_kmers_tpu.core.engine import DeviceEngine, replay_hits
from close_kmers_tpu.db.signature_db import SignatureDB


def random_db(rng, n_funcs=12, prot_len=80):
    """Family-style signature DB: n_funcs reference proteins, each
    contributing its kmers under its own function index — so queries
    containing protein fragments produce real runs."""
    prots = ["".join(rng.choice(list(E.PROT_ALPHA), size=prot_len))
             for _ in range(n_funcs)]
    seen = {}
    for fi, p in enumerate(prots):
        for i in range(len(p) - K + 1):
            km = p[i:i + K]
            if km not in seen:
                seen[km] = (km, int(rng.integers(0, 300)), fi,
                            float(np.float32(rng.uniform(0.1, 5.0))),
                            int(rng.integers(-1, 10)))
    db = SignatureDB.from_entries(seen.values(),
                                  functions=[f"fn{i}" for i in range(n_funcs)])
    db._test_prots = prots
    return db


def random_seqs(rng, db, n=40, max_len=200):
    """Query sequences assembled from reference-protein fragments (runs),
    junk, and ambiguity characters."""
    prots = db._test_prots
    seqs = []
    for _ in range(n):
        parts = []
        total = 0
        target = int(rng.integers(0, max_len))
        while total < target:
            r = rng.random()
            if r < 0.6:
                p = prots[int(rng.integers(0, len(prots)))]
                a = int(rng.integers(0, len(p) - K))
                b = int(rng.integers(a + K, min(len(p), a + 60) + 1))
                s = p[a:b]
            elif r < 0.85:
                s = "".join(rng.choice(list(E.PROT_ALPHA), size=int(rng.integers(1, 12))))
            else:
                s = "".join(rng.choice(list("XxB*"), size=int(rng.integers(1, 3))))
            parts.append(s)
            total += len(s)
        seqs.append("".join(parts))
    return seqs


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(42)
    db = random_db(rng)
    seqs = random_seqs(rng, db)
    eng = DeviceEngine(db)
    return db, seqs, eng


def oracle_run(db, seq, params):
    calls, hits, otu = [], [], O.OtuStats()
    O.process_aa_seq(seq, db.lookup, params, calls, hits.append, otu)
    return calls, hits, otu


def test_hit_lists_match_oracle(setup):
    db, seqs, eng = setup
    params = EngineParams()
    hit_lists = eng.hits_of_batch(seqs)
    n_hits_total = 0
    for seq, eng_hits in zip(seqs, hit_lists):
        _, ora_hits, _ = oracle_run(db, seq, params)
        assert len(eng_hits) == len(ora_hits), seq
        for a, b in zip(eng_hits, ora_hits):
            assert (a.pos, a.fI, a.oI, a.avg_off, a.code) == \
                (b.pos, b.fI, b.oI, b.avg_off, b.code)
            assert np.float32(a.wt) == np.float32(b.wt)
        n_hits_total += len(eng_hits)
    assert n_hits_total > 100  # the corpus actually exercises the probe


def test_calls_and_otus_match_oracle(setup):
    db, seqs, eng = setup
    for params in [EngineParams(), EngineParams(min_hits=2, max_gap=30),
                   EngineParams(min_hits=1), EngineParams(min_weighted_hits=3)]:
        results = eng.process_batch([(f"s{i}", s) for i, s in enumerate(seqs)],
                                    params, want_hits=True)
        n_calls = 0
        for seq, (calls, hits, otu) in zip(seqs, results):
            o_calls, _, o_otu = oracle_run(db, seq, params)
            assert len(calls) == len(o_calls), (seq, params)
            for a, b in zip(calls, o_calls):
                assert (a.start, a.end, a.count, a.fI) == (b.start, b.end, b.count, b.fI)
                assert np.float32(a.weighted) == np.float32(b.weighted)
            assert otu.otus_by_count == o_otu.otus_by_count
            n_calls += len(calls)
        assert n_calls > 0


def test_order_constraint_parity(setup):
    db, seqs, eng = setup
    params = EngineParams(order_constraint=1, min_hits=2)
    results = eng.process_batch([(f"s{i}", s) for i, s in enumerate(seqs)], params)
    for seq, (calls, _, otu) in zip(seqs, results):
        o_calls, _, o_otu = oracle_run(db, seq, params)
        assert [(c.start, c.end, c.count, c.fI) for c in calls] == \
            [(c.start, c.end, c.count, c.fI) for c in o_calls]


def test_probe_empty_and_tiny_sequences(setup):
    db, _, eng = setup
    res = eng.process_batch([("a", ""), ("b", "ACD"), ("c", "A" * K)])
    for calls, _, _ in res:
        assert calls == []


def test_probe_batch_padding_invariance(setup):
    db, seqs, eng = setup
    # The same sequence must produce identical hits regardless of padding.
    h1 = eng.hits_of_batch([seqs[0]])
    h2 = eng.hits_of_batch([seqs[0]], pad_to=512)
    assert [(h.pos, h.fI) for h in h1[0]] == [(h.pos, h.fI) for h in h2[0]]


def test_probe_count_pad_rule():
    # Flat gather counts are padded to the next length ≡ 8 (mod 16)
    # (engine._probe_count_pad).  Padding must be monotone, bounded,
    # and idempotent.
    from close_kmers_tpu.core.engine import _probe_count_pad
    for n in list(range(1, 70)) + [8192 * 304, 8192 * 304 + 1, 2_490_000]:
        m = _probe_count_pad(n)
        assert m >= n and m - n <= 15 and m % 16 == 8
        assert _probe_count_pad(m) == m


def test_probe_flat_pad_parity(setup):
    # A batch whose flat window count is a multiple of 16 (so the pad
    # path actually engages) must match the oracle exactly.
    db, seqs, eng = setup
    s = seqs[0][:40] if len(seqs[0]) >= 40 else (seqs[0] * 5)[:40]
    batch = [s] * 16                        # B*W = 16*(pad_L - 8)
    # pad_to=48 rounds the row width to the next power of two (64), so
    # flat = 16*(64-8) = 896 ≡ 0 (mod 16) — the pad path engages.
    h = eng.hits_of_batch(batch, pad_to=48)
    for hl in h:
        assert [(x.pos, x.fI) for x in hl] == [(x.pos, x.fI) for x in h[0]]


def test_empty_db():
    db = SignatureDB.from_entries([])
    eng = DeviceEngine(db)
    res = eng.process_batch([("a", "MKLVINGKTACDEF")])
    assert res[0][0] == []


def test_replay_equals_inline_state_machine(setup):
    # replay_hits over an oracle-produced hit list reproduces the oracle's
    # calls exactly (the state machine depends only on the hit sequence).
    db, seqs, _ = setup
    params = EngineParams(min_hits=3)
    for seq in seqs[:10]:
        o_calls, o_hits, o_otu = oracle_run(db, seq, params)
        calls, otu = [], O.OtuStats()
        replay_hits(o_hits, params, calls, otu)
        otu.finalize()
        assert [(c.start, c.end, c.count, c.fI) for c in calls] == \
            [(c.start, c.end, c.count, c.fI) for c in o_calls]
        assert otu.otus_by_count == o_otu.otus_by_count


def test_probe_compact_cap_retry(setup):
    """Tiny hit cap forces the retry-with-bigger-cap path; results must
    equal the roomy-cap run."""
    from close_kmers_tpu.core.engine import FastAnnotator
    db, seqs, _ = setup
    fa = FastAnnotator(db)
    offsets, lengths = fa.pad_batch(seqs)
    roomy = fa.probe_compact(offsets, lengths, hits_per_seq_cap=512)
    tight = fa.probe_compact(offsets, lengths, hits_per_seq_cap=1)
    for k in ("pos", "fi", "oi", "avg_off", "code", "row_off"):
        assert np.array_equal(roomy[k], tight[k]), k
    assert np.array_equal(roomy["wt"], tight["wt"])
    assert roomy["row_off"][-1] == len(roomy["pos"]) > 0


def test_probe_layout_parity(setup):
    """All four probe layouts (single-gather payload-wide, 2-gather
    lo-wide, sub-bucket blocks, binary search) must produce identical
    probe outputs."""
    import jax.numpy as jnp
    from close_kmers_tpu.core.engine import (DeviceDB, FastAnnotator,
                                             _probe_batch_jit)
    db, seqs, _ = setup
    fa = FastAnnotator(db)
    offsets, lengths = fa.pad_batch(seqs)
    o, l = jnp.asarray(offsets), jnp.asarray(lengths)
    outs = []
    variants = (
        dict(wide=False, sub=False, wide_lo=False, fused=False),  # bin
        dict(wide=False, sub=False, fused=False),     # scale lo_wide
        dict(wide=False, sub=False),                  # fused packed rows
        dict(wide=False, sub=True, fused=False),      # sub blocks
        dict(wide=True, wide_payload=False, fused=False),  # lo_wide
        dict(wide=True, wide_payload=True))           # payload_wide
    for kw in variants:
        d = DeviceDB.from_db(db, **kw)
        out = _probe_batch_jit(d.bucket_pair, d.lo, d.payload, d.n,
                               d.n_steps, o, l, d.lo_wide, d.payload_wide,
                               d.wide_w, d.sub_header, d.sub_blocks, d.sub_w,
                               d.fused_wide, d.fused_w)
        outs.append([np.asarray(x) for x in out])
    assert outs[0][0].any()  # some hits exist
    for j in range(1, len(outs)):
        for k in range(5):
            assert np.array_equal(outs[0][k], outs[j][k]), (j, k)


def test_encode_paths_parity(setup, monkeypatch):
    """The banded-matmul encode (small L) and the sliced log-tree encode
    (long-contig tiles) must agree bit-for-bit."""
    from close_kmers_tpu.core import engine as E2
    db, seqs, _ = setup
    fa = E2.FastAnnotator(db)
    offsets, lengths = fa.pad_batch(seqs)
    import jax.numpy as jnp
    o, l = jnp.asarray(offsets), jnp.asarray(lengths)
    assert offsets.shape[1] <= E2.MM_ENCODE_MAX_L
    a = [np.asarray(x) for x in E2.encode_windows(o, l)]  # matmul path
    monkeypatch.setattr(E2, "MM_ENCODE_MAX_L", 0)
    b = [np.asarray(x) for x in E2.encode_windows(o, l)]  # log-tree path
    for x, y in zip(a, b):
        assert np.array_equal(x, y)


def test_sub_bucket_probe_matches_binary_search():
    """Deep-bucket DBs (PATRIC density: hundreds of entries per hi
    bucket) use the 2-gather sub-bucket block layout; its probe outputs
    must equal the binary-search fallback's exactly."""
    import jax.numpy as jnp
    from close_kmers_tpu.core.engine import DeviceDB, _probe_batch_jit
    from close_kmers_tpu.db.signature_db import SignatureDB
    from close_kmers_tpu.params import LO_CARD

    rng = np.random.default_rng(11)
    # keys concentrated in a narrow hi range -> ~160 entries per bucket
    n = 80_000
    his = rng.integers(1000, 1500, size=n, dtype=np.int64)
    los = rng.integers(0, LO_CARD, size=n, dtype=np.int64)
    keys = np.unique(his * LO_CARD + los)
    db = SignatureDB(
        keys,
        rng.integers(0, 99, size=len(keys)).astype(np.int32),
        rng.integers(-1, 8, size=len(keys)).astype(np.int32),
        rng.integers(0, 300, size=len(keys)).astype(np.int32),
        rng.uniform(0.1, 3.0, size=len(keys)).astype(np.float32),
    )
    assert db.max_bucket > DeviceDB.WIDE_BUCKET_MAX

    d_sub = DeviceDB.from_db(db)
    assert d_sub.sub_blocks is not None and d_sub.payload_wide is None
    d_bin = DeviceDB.from_db(db, sub=False)
    assert d_bin.sub_blocks is None

    # queries: half spelled from DB kmers (hits), half random (misses)
    from close_kmers_tpu.ops.encoder import decode_kmer, seq_to_offsets
    B, L = 8, 96
    offsets = rng.integers(0, 20, size=(B, L)).astype(np.uint8)
    lengths = np.full(B, L, dtype=np.int32)
    for b in range(B):
        for p in (4, 30, 61):
            km = decode_kmer(int(keys[rng.integers(0, len(keys))]))
            offsets[b, p:p + 8] = seq_to_offsets(km)
    o, l = jnp.asarray(offsets), jnp.asarray(lengths)

    outs = []
    for d in (d_sub, d_bin):
        out = _probe_batch_jit(d.bucket_pair, d.lo, d.payload, d.n,
                               d.n_steps, o, l, d.lo_wide, d.payload_wide,
                               d.wide_w, d.sub_header, d.sub_blocks,
                               d.sub_w)
        outs.append([np.asarray(x) for x in out])
    assert outs[0][0].any()
    for k in range(5):
        assert np.array_equal(outs[0][k], outs[1][k]), k


def test_probe_compact_rows_only_matches_planes():
    """rows_only=True (2-plane download + host payload reconstruction)
    must reproduce every plane of the standard compact probe."""
    from close_kmers_tpu.core.engine import FastAnnotator
    rng = np.random.default_rng(5)
    db = random_db(rng)
    seqs = random_seqs(rng, db, n=12)
    fa = FastAnnotator(db)
    offsets, lengths = fa.pad_batch(seqs)
    want = fa.probe_compact(offsets, lengths)
    got = fa.probe_compact(offsets, lengths, rows_only=True)
    for k in ("pos", "fi", "oi", "avg_off", "code", "row_off"):
        assert np.array_equal(got[k], want[k]), k
    assert np.array_equal(np.float32(got["wt"]), np.float32(want["wt"]))


def test_deep_bucket_db_picks_sub_not_fused():
    """A PATRIC-density DB (deep buckets) must auto-pick the
    depth-insensitive sub-bucket tier; the fused packed-row tier's
    bucket-depth gate (FUSED_BUCKET_MAX) keeps its byte-bound KB rows
    away from deep DBs (a 2219-deep bucket would make 17.8 KB fused
    rows)."""
    from close_kmers_tpu.core.engine import DeviceDB
    from close_kmers_tpu.db.signature_db import SignatureDB
    from close_kmers_tpu.params import LO_CARD
    rng = np.random.default_rng(17)
    n = 40_000
    his = rng.integers(5000, 5080, size=n, dtype=np.int64)   # deep
    keys = np.unique(his * LO_CARD
                     + rng.integers(0, LO_CARD, size=n, dtype=np.int64))
    db = SignatureDB(
        keys, rng.integers(0, 50, size=len(keys)).astype(np.int32),
        rng.integers(-1, 8, size=len(keys)).astype(np.int32),
        rng.integers(0, 300, size=len(keys)).astype(np.int32),
        rng.uniform(0.1, 3.0, size=len(keys)).astype(np.float32))
    assert db.max_bucket > DeviceDB.FUSED_BUCKET_MAX
    ddb = DeviceDB.from_db(db)
    assert ddb.fused_wide is None
    assert ddb.sub_blocks is not None
