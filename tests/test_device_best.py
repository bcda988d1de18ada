"""Device find_best_call reductions vs the CPU oracle — including
tie-heavy constructed cases exercising the libstdc++ heap behavior."""

import numpy as np
import pytest

from close_kmers_tpu.params import EngineParams
from close_kmers_tpu.core import oracle as O
from close_kmers_tpu.core.engine import FastAnnotator
from close_kmers_tpu.core.device_score import DeviceScorer

from test_engine import random_db, random_seqs


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(321)
    db = random_db(rng)
    seqs = random_seqs(rng, db, n=64)
    return db, seqs


@pytest.mark.parametrize("params", [
    EngineParams(),
    EngineParams(min_hits=2, max_gap=40),
    EngineParams(min_hits=1),
])
def test_device_best_matches_oracle(corpus, params):
    db, seqs = corpus
    ds = DeviceScorer(db)
    fa = FastAnnotator(db)
    offsets, lengths = fa.pad_batch(seqs)
    out = np.asarray(ds.best_batch_packed(offsets, lengths, params))
    got = DeviceScorer.finish_best_batch(out, db.function_of)
    n_called = 0
    for seq, g in zip(seqs, got):
        o_calls = []
        O.process_aa_seq(seq, db.lookup, params, o_calls, None, None)
        want = O.find_best_call(o_calls, db.function_of)
        assert g.function_index == want.function_index, seq
        assert g.function == want.function
        assert g.score == want.score
        assert np.float32(g.weighted_score) == np.float32(want.weighted_score)
        assert g.score_offset == want.score_offset
        n_called += g.function_index >= 0 or bool(g.function)
    assert n_called > 10


def _db_from_calls(call_groups):
    """Build a tiny DB + one query per group producing exactly the given
    call sequence (each call = one run of `count` same-fI hits with gaps
    between runs)."""
    from close_kmers_tpu.db.signature_db import SignatureDB
    from close_kmers_tpu.ops import encoder as E
    rng = np.random.default_rng(99)
    entries = {}
    seqs = []
    for calls in call_groups:
        parts = []
        for count, fi, wt in calls:
            # `count` consecutive hit windows need count+7 residues whose
            # every window is a DB kmer of function fi
            frag = "".join(rng.choice(list(E.PROT_ALPHA), size=count + 7))
            for i in range(count):
                entries.setdefault(frag[i:i + 8], (frag[i:i + 8], 10, fi,
                                                   wt, -1))
            parts.append(frag)
            parts.append("X")  # break runs without a gap>200
        seqs.append("".join(parts))
    db = SignatureDB.from_entries(
        entries.values(), functions=[f"f{i}" for i in range(20)])
    return db, seqs


def test_device_best_tie_cases():
    """Equal weighted totals between functions: the heap's deterministic
    tie behavior must match the oracle exactly."""
    groups = [
        # two functions, identical counts & weights (full tie)
        [(6, 1, 1.0), (6, 2, 1.0)],
        # three functions, ties between top two
        [(8, 3, 1.0), (8, 4, 1.0), (6, 5, 1.0)],
        # three functions all tied
        [(7, 6, 2.0), (7, 7, 2.0), (7, 8, 2.0)],
        # clear winner
        [(12, 9, 1.0), (5, 10, 1.0)],
        # ambiguous with pair offset (n=3, second >> third)
        [(20, 11, 1.0), (18, 12, 1.0), (6, 13, 1.0)],
    ]
    db, seqs = _db_from_calls(groups)
    params = EngineParams(min_hits=3, max_gap=200)
    ds = DeviceScorer(db)
    fa = FastAnnotator(db)
    offsets, lengths = fa.pad_batch(seqs)
    out = np.asarray(ds.best_batch_packed(offsets, lengths, params))
    got = DeviceScorer.finish_best_batch(out, db.function_of)
    for seq, g in zip(seqs, got):
        o_calls = []
        O.process_aa_seq(seq, db.lookup, params, o_calls, None, None)
        # sanity: the constructed sequences produce multiple calls
        want = O.find_best_call(o_calls, db.function_of)
        assert g.function_index == want.function_index, (seq[:20], want)
        assert g.function == want.function
        assert g.score == want.score
        assert g.score_offset == want.score_offset
        assert np.float32(g.weighted_score) == np.float32(want.weighted_score)


def test_device_best_bridge_merge():
    """F1 | small F2 | F1 bridge: interior discarded on device too."""
    groups = [[(6, 1, 1.0), (4, 2, 1.0), (6, 1, 1.0)],
              [(6, 3, 1.0), (5, 4, 1.0), (6, 3, 1.0)]]  # 5 interior: no merge
    db, seqs = _db_from_calls(groups)
    params = EngineParams(min_hits=3)
    ds = DeviceScorer(db)
    fa = FastAnnotator(db)
    offsets, lengths = fa.pad_batch(seqs)
    out = np.asarray(ds.best_batch_packed(offsets, lengths, params))
    got = DeviceScorer.finish_best_batch(out, db.function_of)
    for seq, g in zip(seqs, got):
        o_calls = []
        O.process_aa_seq(seq, db.lookup, params, o_calls, None, None)
        want = O.find_best_call(o_calls, db.function_of)
        assert (g.function_index, g.function, g.score, g.score_offset) == \
            (want.function_index, want.function, want.score, want.score_offset)


def test_best_calls_batch_overflow_fallback():
    """Rows with >32 calls trip the device cap flag; best_calls_batch
    must re-score them exactly instead of raising (device_score
    OverflowError escape)."""
    from close_kmers_tpu.db.signature_db import SignatureDB
    from close_kmers_tpu.ops.encoder import decode_kmer

    rng = np.random.default_rng(99)
    n_f = 40
    entries = []
    kmers = []
    alpha = "ACDEFGHIKLMNPQRSTVWY"
    seen = set()
    while len(kmers) < n_f:
        k = "".join(rng.choice(list(alpha), size=8))
        if k in seen:
            continue
        seen.add(k)
        kmers.append(k)
        entries.append((k, 5, len(kmers) - 1, 1.0, -1))
    db = SignatureDB.from_entries(entries,
                                  functions=[f"f{i}" for i in range(n_f)])
    # 40 single-function blocks -> 40 calls at min_hits=1 (function
    # changes flush runs); plus a small normal row
    big = "".join(k + k for k in kmers)
    small = kmers[0] * 3
    params = EngineParams(min_hits=1)
    ds = DeviceScorer(db)
    fa = FastAnnotator(db)
    offsets, lengths = fa.pad_batch([big, small])
    out = np.asarray(ds.best_batch_packed(offsets, lengths, params))
    assert out.shape[1] > 8 and out[0, 8] != 0, "cap flag must trip"
    with pytest.raises(OverflowError):
        DeviceScorer.finish_best_batch(out, db.function_of)
    got = ds.best_calls_batch(offsets, lengths, db.function_of, params)
    for seq, g in zip([big, small], got):
        o_calls = []
        O.process_aa_seq(seq, db.lookup, params, o_calls, None, None)
        want = O.find_best_call(o_calls, db.function_of)
        assert g.function_index == want.function_index
        assert np.float32(g.weighted_score) == np.float32(want.weighted_score)
        assert g.score == want.score
