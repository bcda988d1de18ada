"""On-device family rollup vs the host accumulation path."""

import numpy as np
import pytest

from close_kmers_tpu.core import family as F
from close_kmers_tpu.core.engine import FastAnnotator, DeviceEngine
from close_kmers_tpu.core.device_family import DeviceFamilyScorer
from close_kmers_tpu.db.family_db import KmerFamilyMapping

from test_engine import random_db, random_seqs


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(55)
    db = random_db(rng)
    seqs = random_seqs(rng, db, n=24)
    mapping = KmerFamilyMapping()
    for k in db.keys:
        for fid in set(rng.integers(0, 40, size=rng.integers(1, 5)).tolist()):
            mapping.add_fam_mapping(int(fid), int(k))
    return db, seqs, mapping


def test_device_rollup_matches_host(setup):
    db, seqs, mapping = setup
    dfs = DeviceFamilyScorer(db, mapping)
    eng = DeviceEngine(db)
    fa = FastAnnotator(db)
    offsets, lengths = fa.pad_batch(seqs)
    n_per_seq, fam, counts, weights, first = dfs.rollup(offsets, lengths)

    hit_lists = eng.hits_of_batch(seqs)
    k = 0
    total = 0
    for s, seq in enumerate(seqs):
        py = F.accumulate_family_scores(hit_lists[s], mapping)
        n = int(n_per_seq[s])
        got = {int(fam[k + i]): (int(counts[k + i]), float(weights[k + i]))
               for i in range(n)}
        want = {fid: (ss.hit_count, float(ss.weighted_total))
                for fid, ss in py.items()}
        assert set(got) == set(want), s
        for fid in want:
            assert got[fid][0] == want[fid][0]          # counts exact
            # the row-sorted grouping scan adds weights in the host
            # path's exact visit order — bit-identical f32 sums
            assert got[fid][1] == want[fid][1]
        # device entries are family-id ordered within a sequence
        assert [int(fam[k + i]) for i in range(n)] == sorted(got)
        # the first-hit positions recover the host's insertion order
        order = np.argsort(first[k:k + n], kind="stable")
        assert [int(fam[k + i]) for i in order] == list(want)
        k += n
        total += n
    assert total > 50


def test_device_rollup_cap_retry(setup):
    db, seqs, mapping = setup
    dfs = DeviceFamilyScorer(db, mapping)
    fa = FastAnnotator(db)
    offsets, lengths = fa.pad_batch(seqs)
    a = dfs.rollup(offsets, lengths, fams_per_seq_cap=1)
    b = dfs.rollup(offsets, lengths, fams_per_seq_cap=64)
    for x, y in zip(a, b):
        assert np.array_equal(np.asarray(x), np.asarray(y))


def test_device_rollup_no_hits(setup):
    db, _, mapping = setup
    dfs = DeviceFamilyScorer(db, mapping)
    offsets = np.full((4, 64), 20, dtype=np.uint8)
    lengths = np.zeros(4, dtype=np.int32)
    n_per_seq, fam, counts, weights, first = dfs.rollup(offsets, lengths)
    assert n_per_seq.sum() == 0 and len(fam) == 0


def test_annotate_family_device_matches_host(setup):
    """KmerEngine.annotate_family must produce byte-identical results and
    seq_scores (including dict ORDER — downstream tie-breaking and PGF
    f32 rollups depend on it) whether the fused device program or the
    compact-hit host path runs."""
    from close_kmers_tpu.core.api import KmerEngine
    from close_kmers_tpu.core import family as F
    from close_kmers_tpu.db.family_db import FamilyData

    db, seqs, mapping = setup
    for fid in range(40):
        mapping.families.append(FamilyData(
            pgf=f"PGF_{fid % 7:08d}", plf=f"PLF_83333_{fid:08d}",
            genus_id=83333, function=f"fn {fid % 5}", family_id=fid,
            total_size=10 + fid, count=3))
    items = [(f"q{i}", s) for i, s in enumerate(seqs)]

    host = KmerEngine(db, device_family=False)
    dev = KmerEngine(db, device_family=True, device_family_min=0)
    assert host._device_family_scorer(mapping) is None
    r_host, s_host = host.annotate_family(items, mapping, want_best=True)
    if hasattr(mapping, "_device_scorer"):
        del mapping._device_scorer
    assert dev._device_family_scorer(mapping) is not None
    r_dev, s_dev = dev.annotate_family(items, mapping, want_best=True)

    assert len(s_host) == len(s_dev) == len(items)
    for a, b in zip(s_host, s_dev):
        assert list(a) == list(b)          # first-hit ORDER preserved
        for fid in a:
            assert a[fid].hit_count == b[fid].hit_count
            assert a[fid].hit_total == b[fid].hit_total
            assert np.float32(a[fid].weighted_total) == \
                np.float32(b[fid].weighted_total)
    for ra, rb in zip(r_host, r_dev):
        assert ra.seq_id == rb.seq_id
        assert [dataclasses_tuple(c) for c in ra.calls] == \
            [dataclasses_tuple(c) for c in rb.calls]
        assert (ra.best is None) == (rb.best is None)
        if ra.best:
            assert ra.best.function == rb.best.function
            assert ra.best.score == rb.best.score
            assert ra.best.weighted_score == rb.best.weighted_score
    # the formatted outputs (what the server writes) agree byte-for-byte
    for s, (ra, rb) in enumerate(zip(r_host, r_dev)):
        ma = F.find_best_family_match(ra.best, s_host[s], mapping, 3,
                                      False, 83333)
        mb = F.find_best_family_match(rb.best, s_dev[s], mapping, 3,
                                      False, 83333)
        assert F.format_best_match_lookup(ra.seq_id, ma) == \
            F.format_best_match_lookup(rb.seq_id, mb)
        assert F.all_matches_rows(s_host[s], mapping, 3) == \
            F.all_matches_rows(s_dev[s], mapping, 3)


def dataclasses_tuple(c):
    return (c.start, c.end, c.count, c.fI, np.float32(c.weighted))


def test_rollup_cap_escalation_sticky(setup):
    """Forcing the overflow path must produce identical results and
    raise the instance's default cap so later batches skip the retry."""
    db, seqs, mapping = setup
    from close_kmers_tpu.core.engine import FastAnnotator
    dfs = DeviceFamilyScorer(db, mapping)
    fa = FastAnnotator(db)
    offsets, lengths = fa.pad_batch(seqs)
    roomy = dfs.rollup(offsets, lengths, 64)
    tight = dfs.rollup(offsets, lengths, 1)   # forces escalation
    for a, b in zip(roomy, tight):
        assert np.array_equal(a, b)
    if int(roomy[0].sum()) > len(seqs):       # overflow actually happened
        assert dfs._default_cap >= 4 or dfs._default_cap == 8
    after = dfs.rollup(offsets, lengths)      # sticky default path
    for a, b in zip(roomy, after):
        assert np.array_equal(a, b)


def test_device_rollup_sub_bucket_layout(setup):
    """The family rollup must be identical when the engine probes via
    the deep-bucket sub-bucket layout (idx stays the global DB row)."""
    from close_kmers_tpu.core.engine import DeviceDB

    db, seqs, mapping = setup
    dfs_wide = DeviceFamilyScorer(db, mapping)
    assert dfs_wide.ddb.payload_wide is not None
    ddb_sub = DeviceDB.from_db(db, wide=False, fused=False)
    assert ddb_sub.sub_blocks is not None
    dfs_sub = DeviceFamilyScorer(db, mapping, ddb=ddb_sub)

    fa = FastAnnotator(db)
    offsets, lengths = fa.pad_batch(seqs)
    a = dfs_wide.rollup(offsets, lengths)
    b = dfs_sub.rollup(offsets, lengths)
    for x, y in zip(a, b):
        assert np.array_equal(np.asarray(x, dtype=np.float64),
                              np.asarray(y, dtype=np.float64))


def test_best_match_group_pipelining(setup, monkeypatch):
    """best_family_matches_padded's grouped-readback pipeline (chunks
    split across several D2H groups, each overlapping the next group's
    dispatch) must produce exactly the same matches as the single-group
    path, including across the group boundary and a padded tail chunk."""
    from close_kmers_tpu.core.api import KmerEngine

    db, seqs, mapping = setup
    items = [(f"q{i}", s) for i, s in enumerate(seqs)]
    eng = KmerEngine(db, device_family=True, device_family_min=0)
    assert eng._device_family_scorer(mapping) is not None
    want = eng.best_family_matches(items, mapping, target_genus_id=83333)

    # 24 seqs -> chunk B=8 -> 3 chunks -> 2 groups (2 + 1-with-pad-tail)
    monkeypatch.setattr(KmerEngine, "FAMILY_MATCH_CHUNK", 8)
    monkeypatch.setattr(KmerEngine, "FAMILY_MATCH_GROUP", 2)
    got = eng.best_family_matches(items, mapping, target_genus_id=83333)
    assert len(got) == len(want) == len(items)
    for a, b in zip(want, got):
        assert a == b


def test_hierarchical_global_pack_identical(setup):
    """rollup_from_fams(cap_seq<0, row_cap>0) must produce a buffer
    bit-identical to the flat global pack whenever no row overflows
    row_cap, and finish_rollup_global must flag row overflow."""
    import jax.numpy as jnp
    from close_kmers_tpu.core.device_family import (
        DeviceFamilyDB, _gather_fams, rollup_from_fams)
    from close_kmers_tpu.core.engine import (DeviceDB, FastAnnotator,
                                             encode_windows, probe_windows)

    db, seqs, mapping = setup
    fa = FastAnnotator(db)
    offsets, lengths = fa.pad_batch(seqs)
    ddb = DeviceDB.from_db(db)
    fdb = DeviceFamilyDB.from_mapping(db, mapping)
    hi, lo, valid = encode_windows(jnp.asarray(offsets),
                                   jnp.asarray(lengths))
    *_, idx = probe_windows(ddb, hi, lo, valid)
    fams = _gather_fams(fdb.fam, idx)
    B = offsets.shape[0]
    gcap = 64 * B
    flat = np.asarray(rollup_from_fams(fams, -gcap))
    hier = np.asarray(rollup_from_fams(fams, -gcap, row_cap=48))
    n_per = flat[:B]
    assert int(n_per.max()) <= 48 and int(n_per.sum()) > 50
    total = int(n_per.sum())
    assert np.array_equal(hier[:B], flat[:B])
    nplanes = 3 if (fams.shape[1] * fams.shape[2] + 1) < (1 << 15) else 4
    fp = flat[B:].reshape(nplanes, -1)[:, :total]
    hp = hier[B:].reshape(nplanes, -1)[:, :total]
    assert np.array_equal(fp, hp)

    # these shapes fold (cnt<<16|first) into one plane on device
    Wp, D = fams.shape[1], fams.shape[2]
    folded = (Wp * D + 1) < (1 << 15)
    assert folded

    # overflow detection: a row_cap below the max row count -> None
    r = DeviceFamilyScorer.finish_rollup_global(
        np.asarray(rollup_from_fams(fams, -gcap, row_cap=1)), B, gcap,
        row_cap=1, folded=folded)
    if int(n_per.max()) > 1:
        assert r is None
    ok = DeviceFamilyScorer.finish_rollup_global(hier, B, gcap,
                                                 row_cap=48, folded=folded)
    assert ok is not None
    want = DeviceFamilyScorer.finish_rollup_global(flat, B, gcap,
                                                   folded=folded)
    for a, b in zip(ok, want):
        assert np.array_equal(a, b)


def test_famwide_path_identical(setup):
    """The folded single-gather family rows (famwide_from_mapping) must
    make score_family_packed produce buffers bit-identical to the
    two-gather path, and best_family_matches must agree end-to-end."""
    from close_kmers_tpu.core.api import KmerEngine
    from close_kmers_tpu.core.engine import FastAnnotator
    from close_kmers_tpu.params import EngineParams

    db, seqs, mapping = setup
    fa = FastAnnotator(db)
    offsets, lengths = fa.pad_batch(seqs)
    params = EngineParams()
    base = DeviceFamilyScorer(db, mapping, famwide=False)
    fw = DeviceFamilyScorer(db, mapping, famwide=True)
    assert base.famwide is None and fw.famwide is not None
    B = offsets.shape[0]
    for cap in (4 * B, -4 * B):
        a_calls, acap, a_rows, _ = base.score_family_packed(
            offsets, lengths, params, 4, cap, slim_calls=True)
        b_calls, bcap, b_rows, _ = fw.score_family_packed(
            offsets, lengths, params, 4, cap, slim_calls=True)
        assert acap == bcap
        assert np.array_equal(np.asarray(a_calls), np.asarray(b_calls))
        assert np.array_equal(np.asarray(a_rows), np.asarray(b_rows))

    # order_constraint falls back to the two-gather path (no avg plane)
    oc = EngineParams(order_constraint=True)
    c_calls, ccap2, c_rows, _ = fw.score_family_packed(
        offsets, lengths, oc, 4, 4 * B, slim_calls=True)
    d_calls, dcap2, d_rows, _ = base.score_family_packed(
        offsets, lengths, oc, 4, 4 * B, slim_calls=True)
    assert np.array_equal(np.asarray(c_calls), np.asarray(d_calls))
    assert np.array_equal(np.asarray(c_rows), np.asarray(d_rows))
