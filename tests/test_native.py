"""Native C++ scorer parity vs the CPU oracle, and fast-path pipeline
equivalence."""

import numpy as np
import pytest

from close_kmers_tpu.params import EngineParams
from close_kmers_tpu.core import oracle as O, family as F
from close_kmers_tpu.core.engine import FastAnnotator, DeviceEngine, finish_best_call
from close_kmers_tpu.native import api as native
from close_kmers_tpu.db.family_db import KmerFamilyMapping

from test_engine import random_db, random_seqs


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(123)
    db = random_db(rng)
    seqs = random_seqs(rng, db, n=50)
    return db, seqs


def oracle_all(db, seq, params):
    calls, hits, otu = [], [], O.OtuStats()
    O.process_aa_seq(seq, db.lookup, params, calls, hits.append, otu)
    return calls, hits, otu


@pytest.mark.parametrize("params", [
    EngineParams(),
    EngineParams(min_hits=2, max_gap=50),
    EngineParams(order_constraint=1, min_hits=2),
    EngineParams(min_weighted_hits=4),
])
def test_native_scoring_matches_oracle(corpus, params):
    db, seqs = corpus
    fa = FastAnnotator(db)
    h, n_calls, (cs, ce, cc, cf, cw), votes = fa.annotate(
        seqs, params, want_votes=True)
    total_calls = 0
    for s, seq in enumerate(seqs):
        o_calls, o_hits, o_otu = oracle_all(db, seq, params)
        got = [(int(cs[s, i]), int(ce[s, i]), int(cc[s, i]), int(cf[s, i]))
               for i in range(n_calls[s])]
        want = [(c.start, c.end, c.count, c.fI) for c in o_calls]
        assert got == want, (s, seq)
        for i, c in enumerate(o_calls):
            assert np.float32(cw[s, i]) == np.float32(c.weighted)
        # OTU votes: aggregate flags == oracle otu map
        a, b = h["row_off"][s], h["row_off"][s + 1]
        otu_map = {}
        for k in range(a, b):
            if votes[k]:
                oi = int(h["oi"][k])
                otu_map[oi] = otu_map.get(oi, 0) + 1
        assert otu_map == o_otu.otu_map
        total_calls += len(o_calls)
    assert total_calls > 20


def test_native_best_call_matches_oracle(corpus):
    db, seqs = corpus
    fa = FastAnnotator(db)
    params = EngineParams(min_hits=2)
    bests = fa.best_calls(seqs, db.function_of, params)
    for seq, got in zip(seqs, bests):
        o_calls, _, _ = oracle_all(db, seq, params)
        want = O.find_best_call(o_calls, db.function_of)
        assert got.function_index == want.function_index
        assert got.function == want.function
        assert got.score == want.score
        assert np.float32(got.weighted_score) == np.float32(want.weighted_score)
        assert got.score_offset == want.score_offset


def test_native_family_scores_match_python(corpus):
    db, seqs = corpus
    fa = FastAnnotator(db)
    eng = DeviceEngine(db)
    # Build a family mapping: each function index is its own family.
    mapping = KmerFamilyMapping()
    rng = np.random.default_rng(5)
    for k in db.keys:
        for fid in set(rng.integers(0, 6, size=rng.integers(1, 4)).tolist()):
            mapping.add_fam_mapping(int(fid), int(k))
    keys, offs, vals = mapping.fam_csr()

    h = fa.probe_compact(*fa.pad_batch(seqs))
    out_n, fam, hits_c, weight = native.family_scores(
        h["code"], h["row_off"], keys, offs, vals)

    hit_lists = eng.hits_of_batch(seqs)
    w = 0
    for s, seq in enumerate(seqs):
        py = F.accumulate_family_scores(hit_lists[s], mapping)
        n = int(out_n[s])
        got = {int(fam[w + i]): (int(hits_c[w + i]), np.float32(weight[w + i]))
               for i in range(n)}
        want = {fid: (ss.hit_count, np.float32(ss.weighted_total))
                for fid, ss in py.items()}
        assert got == want, s
        # insertion order must match too (first-hit order)
        assert [int(fam[w + i]) for i in range(n)] == list(py.keys())
        w += n


def test_native_pipeline_batch_smoke(corpus):
    db, seqs = corpus
    fa = FastAnnotator(db)
    offsets, lengths = fa.pad_batch(seqs)
    n_calls = native.pipeline_batch(db, offsets, lengths, min_hits=2)
    # must agree with the device+native path
    _, n_calls2, _, _ = fa.annotate(seqs, EngineParams(min_hits=2))
    assert n_calls.tolist() == n_calls2.tolist()


def test_hash_pipeline_matches_sorted(corpus):
    """The reference-architecture open-addressed hash baseline produces
    identical calls to the sorted-index pipeline and the device path."""
    db, seqs = corpus
    fa = FastAnnotator(db)
    offsets, lengths = fa.pad_batch(seqs)
    sorted_calls = native.pipeline_batch(db, offsets, lengths, min_hits=2)
    hp = native.HashPipeline(db)
    hash_calls = hp.run(offsets, lengths, min_hits=2)
    assert sorted_calls.tolist() == hash_calls.tolist()
