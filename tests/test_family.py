"""Family DB + family scoring tests: families.dat parsing, NR preload,
best global/local family selection, all-matches report."""

import numpy as np
import pytest

from close_kmers_tpu.params import EngineParams, K
from close_kmers_tpu.ops import encoder as E
from close_kmers_tpu.core import oracle as O, family as F
from close_kmers_tpu.core.engine import DeviceEngine, replay_hits
from close_kmers_tpu.db.signature_db import SignatureDB
from close_kmers_tpu.db.family_db import KmerFamilyMapping, FamilyReps


@pytest.fixture(scope="module")
def universe(tmp_path_factory):
    """A tiny PATRIC-like universe: 3 functions, 4 local families across 2
    genera, one reference protein per family."""
    rng = np.random.default_rng(7)
    tmp = tmp_path_factory.mktemp("fam")
    funcs = ["DNA gyrase subunit B", "Acetate kinase", "hypothetical protein"]
    # (peg, function_index, genus, local-fam-number)
    fam_spec = [
        ("fig|100.1.peg.1", 0, "Leptospira", "1"),
        ("fig|100.1.peg.2", 0, "Bacillus", "2"),
        ("fig|100.1.peg.3", 1, "Leptospira", "3"),
        ("fig|100.1.peg.4", 2, "Bacillus", "4"),
    ]
    prots = {}
    for peg, fi, genus, lf in fam_spec:
        prots[peg] = "".join(rng.choice(list(E.PROT_ALPHA), size=90))

    genus_file = tmp / "genus.map"
    genus_file.write_text("Leptospira\t171\nBacillus\t1386\n")

    fam_file = tmp / "families.dat"
    with open(fam_file, "w") as f:
        for i, (peg, fi, genus, lf) in enumerate(fam_spec):
            f.write(f"GF0000000{i}\t1\t1\t{peg}\t{len(prots[peg])}\t"
                    f"{funcs[fi]}\t{lf}\t{genus}\t{lf}\n")

    nr_file = tmp / "families.nr"
    with open(nr_file, "w") as f:
        for peg, fi, genus, lf in fam_spec:
            f.write(f">{peg}\n{prots[peg]}\n")

    # Signature DB: all kmers of each protein under its function.
    seen = {}
    for peg, fi, genus, lf in fam_spec:
        p = prots[peg]
        for i in range(len(p) - K + 1):
            seen.setdefault(p[i:i + K], (p[i:i + K], 10, fi, 1.0, -1))
    db = SignatureDB.from_entries(seen.values(), functions=funcs)

    eng = DeviceEngine(db)
    mapping = KmerFamilyMapping()
    mapping.load_genus_map(str(genus_file))
    mapping.load_families(str(fam_file))
    n = mapping.load_nr(str(nr_file), eng)
    assert n == 4
    return dict(db=db, eng=eng, mapping=mapping, prots=prots,
                fam_spec=fam_spec, funcs=funcs, tmp=tmp,
                nr_path=str(nr_file))


def test_load_families_metadata(universe):
    m = universe["mapping"]
    assert len(m.families) == 4
    fd = m.families[0]
    assert fd.pgf == "PGF_00000000"
    assert fd.plf == "PLF_171_00000001"
    assert fd.genus_id == 171
    assert fd.function == "DNA gyrase subunit B"
    assert fd.total_size == 90 and fd.count == 1
    fd2 = m.families[1]
    assert fd2.plf == "PLF_1386_00000002" and fd2.genus_id == 1386


def test_unmapped_genus_fallback(universe, tmp_path):
    m = KmerFamilyMapping()
    fam_file = tmp_path / "f.dat"
    fam_file.write_text("GF00000009\t1\t1\tfig|1.1.peg.1\t50\tfn\t7\tUnknownia\t7\n")
    m.load_families(str(fam_file))
    assert m.families[0].plf == "PLF_Unknownia_00000007"
    assert m.families[0].genus_id == 0


def test_kmer_family_map_dedup(universe):
    m = universe["mapping"]
    keys, offs, vals = m.fam_csr()
    assert len(keys) > 100
    # per-kmer family lists are deduped (kmer.cc:216-230)
    for i in range(len(keys)):
        fams = vals[offs[i]:offs[i + 1]].tolist()
        assert len(set(fams)) == len(fams)


def test_bulk_delta_merge(universe):
    """load_nr's bulk CSR + /add's delta dict merge: bulk entries first,
    delta appended, pairs already in bulk are no-ops."""
    m = universe["mapping"]
    keys, offs, vals = m.fam_csr()
    k0 = int(keys[0])
    bulk_fams = vals[offs[0]:offs[1]].tolist()
    m.add_fam_mapping(bulk_fams[0], k0)          # no-op: already in bulk
    m.add_fam_mapping(3, k0)                     # new fam appended
    m.add_fam_mapping(3, k0)                     # delta dedup
    novel = 19_999_999_999                       # kmer absent from bulk
    m.add_fam_mapping(2, novel)
    assert m.families_of_kmer(k0) == bulk_fams + [3]
    assert m.families_of_kmer(novel) == [2]
    keys2, offs2, vals2 = m.fam_csr()
    i = int(np.searchsorted(keys2, k0))
    assert vals2[offs2[i]:offs2[i + 1]].tolist() == bulk_fams + [3]
    assert len(keys2) == len(keys) + 1
    # restore the fixture universe for later tests
    m._kmer_to_fams.clear()
    m._fam_csr = None


def test_add_before_nr_ingest_dedups(universe):
    """A (kmer, fam) pair /add'ed BEFORE the NR preload ingests the same
    pair must not appear twice in the merged CSR (reference set
    semantics, kmer.cc:216-230): add_fam_mapping's bulk guard can't see
    a bulk CSR that doesn't exist yet, so fam_csr's merge dedups."""
    from close_kmers_tpu.db.family_db import KmerFamilyMapping
    m = KmerFamilyMapping()
    m.add_fam_mapping(7, 1234567)            # delta first (no bulk yet)
    m.add_fam_mapping(9, 1234567)
    m._ingest_bulk_fam(np.array([1234567, 1234567], dtype=np.int64),
                       np.array([7, 5], dtype=np.int32))  # NR ingests 7 too
    keys, offs, vals = m.fam_csr()
    i = int(np.searchsorted(keys, 1234567))
    fams = vals[offs[i]:offs[i + 1]].tolist()
    assert sorted(fams) == [5, 7, 9]          # no duplicate 7
    # bulk order first, then novel delta entries
    assert fams == [7, 5, 9]


def test_load_nr_periodic_ingest(universe, tmp_path, monkeypatch):
    """load_nr with a tiny ingest threshold (forcing multiple incremental
    bulk merges) produces the same CSR as one big ingest."""
    from close_kmers_tpu.db.family_db import KmerFamilyMapping
    eng, m0 = universe["eng"], universe["mapping"]
    nr = universe["nr_path"]
    ref = m0._bulk_fam

    m2 = KmerFamilyMapping()
    m2.genus_map.update(m0.genus_map)
    m2.families = m0.families
    m2.peg_names = list(m0.peg_names)
    m2.peg_to_id = dict(m0.peg_to_id)
    m2.peg_to_family = dict(m0.peg_to_family)
    monkeypatch.setattr(KmerFamilyMapping, "NR_INGEST_PAIRS", 8)
    m2.load_nr(nr, eng, batch_size=2)
    assert np.array_equal(m2._bulk_fam[0], ref[0])
    assert np.array_equal(m2._bulk_fam[1], ref[1])
    assert np.array_equal(m2._bulk_fam[2], ref[2])


def test_best_match_exact_protein(universe):
    eng, m, prots = universe["eng"], universe["mapping"], universe["prots"]
    db = universe["db"]
    peg, fi, genus, lf = universe["fam_spec"][0]
    res = F.annotate_best_match(eng, [(peg, prots[peg])], m, db.function_of,
                                genus_filter=False)
    sid, bm = res[0]
    assert sid == peg
    assert bm.gfam_id == "PGF_00000000"
    assert bm.lfam_id == "PLF_171_00000001"
    assert bm.function == "DNA gyrase subunit B"
    assert bm.score > 5
    assert bm.gfam_score > 0 and bm.lfam_score > 0


def test_best_match_genus_filter(universe):
    """With the /lookup genus filter active, the local family must match
    the target genus (lookup_request.cc:300)."""
    eng, m, prots, db = (universe["eng"], universe["mapping"],
                         universe["prots"], universe["db"])
    peg = universe["fam_spec"][0][0]
    res = F.annotate_best_match(eng, [(peg, prots[peg])], m, db.function_of,
                                genus_filter=True, target_genus_id=171)
    assert res[0][1].lfam_id == "PLF_171_00000001"
    res = F.annotate_best_match(eng, [(peg, prots[peg])], m, db.function_of,
                                genus_filter=True, target_genus_id=1386)
    # No local family of genus 1386 carries this function's kmers.
    assert res[0][1].lfam_id == ""
    # The global family result is unaffected by the genus filter.
    assert res[0][1].gfam_id == "PGF_00000000"


def test_no_call_gives_hypothetical(universe):
    eng, m, db = universe["eng"], universe["mapping"], universe["db"]
    res = F.annotate_best_match(eng, [("q", "MKKKKKKKKLVVVVV")], m,
                                db.function_of, genus_filter=False)
    bm = res[0][1]
    assert bm.function == "hypothetical protein"
    assert bm.gfam_id == "" and bm.score == 0.0


def test_all_matches_rows(universe):
    eng, m, prots, db = (universe["eng"], universe["mapping"],
                         universe["prots"], universe["db"])
    peg = universe["fam_spec"][0][0]
    hits = eng.hits_of_batch([prots[peg]])[0]
    seq_score = F.accumulate_family_scores(hits, m)
    body = F.all_matches_rows(seq_score, m, kmer_hit_threshold=3)
    lines = body.strip().split("\n")
    assert lines[-1] == "//"
    first = lines[0].split("\t")
    # hit_count, hit_total, weighted, pgf, plf, total_size, count, scaled, fn
    assert first[3] == "PGF_00000000"
    assert first[4] == "PLF_171_00000001"
    assert first[8] == "DNA gyrase subunit B"
    assert int(first[0]) == int(first[1]) >= 3


def test_weight_is_one_over_n_families(universe):
    """A kmer shared by two families contributes 1/2 to each."""
    m = KmerFamilyMapping()
    m.families = universe["mapping"].families
    code = 12345
    m.add_fam_mapping(0, code)
    m.add_fam_mapping(1, code)
    m.add_fam_mapping(0, code)  # dup ignored
    h = O.Hit(oI=-1, pos=0, avg_off=0, fI=0, wt=1.0, code=code)
    ss = F.accumulate_family_scores([h, h], m)
    assert ss[0].hit_count == 2
    assert np.float32(ss[0].weighted_total) == np.float32(1.0)
    assert np.float32(ss[1].weighted_total) == np.float32(1.0)


def test_ambiguous_function_split():
    bc = O.BestCall(-1, "fnB ?? fnA", 8.0, 8.0, 2.0)
    fn, ambig, do = F.resolve_best_call_function(bc, True)
    assert (fn, ambig, do) == ("fnB", "fnA", True)
    fn, ambig, do = F.resolve_best_call_function(bc, False)
    assert (fn, do) == ("hypothetical protein", False)
    fn, _, _ = F.resolve_best_call_function(O.BestCall(-1, "", 0, 0, 0), False)
    assert fn == "hypothetical protein"


def test_family_reps(tmp_path):
    reps_file = tmp_path / "reps.tsv"
    reps_file.write_text(
        "h0\th1\th2\th3\th4\th5\th6\th7\th8\th9\n"
        "x\tx\tfig|1.2.peg.3\tPLF_171_00000001\tx\tcontig7\t100\t400\t+\t5000\n"
        "short\tline\n")
    fr = FamilyReps()
    fr.load_reps_file(str(reps_file))
    assert list(fr.reps) == ["PLF_171_00000001"]
    r = fr.reps["PLF_171_00000001"][0]
    assert (r.feature_id, r.contig, r.start, r.end, r.strand, r.contig_length) == \
        ("fig|1.2.peg.3", "contig7", 100, 400, "+", 5000)


def test_batch_best_match_parity():
    """find_best_family_matches_batch must equal the scalar scan exactly
    across random rollups, thresholds, genus filters, and ambiguity."""
    from close_kmers_tpu.db.family_db import FamilyData

    rng = np.random.default_rng(99)
    for trial in range(40):
        n_funcs = int(rng.integers(1, 8))
        F_n = int(rng.integers(1, 30))
        mapping = KmerFamilyMapping()
        mapping.families = [
            FamilyData(f"PGF_{rng.integers(0, 6):05d}", f"PLF_{f:05d}",
                       int(rng.integers(0, 3)), f"fn{rng.integers(0, n_funcs)}",
                       f, 5, 5)
            for f in range(F_n)]
        S = int(rng.integers(1, 12))
        n_per = rng.integers(0, min(8, F_n + 3), size=S)
        N = int(n_per.sum())
        # family ids unique within a row (the device rollup groups by
        # family), possibly out of range like real miss rows
        fam = np.concatenate([
            rng.choice(np.arange(-1, F_n + 2), size=n, replace=False)
            for n in n_per]).astype(np.int32) if N else np.zeros(0, np.int32)
        cnt = rng.integers(1, 7, size=N).astype(np.int32)
        # duplicated weights force f32 tie/order effects
        wt = rng.choice(np.float32([0.0, 0.25, 0.5, 0.5, 1.5]), size=N)
        first = rng.permutation(N).astype(np.int32)
        allow_ambig = bool(rng.integers(0, 2))
        genus_filter = bool(rng.integers(0, 2))
        thr = int(rng.integers(1, 4))
        tg = int(rng.integers(0, 3))
        bests = []
        for s in range(S):
            r = rng.random()
            if r < 0.25:
                fn = ""
            elif r < 0.45:
                fn = f"fn{rng.integers(0, n_funcs)} ?? fn{rng.integers(0, n_funcs)}"
            else:
                fn = f"fn{rng.integers(0, n_funcs + 2)}"  # sometimes unknown
            bests.append(O.BestCall(0, fn, float(rng.integers(0, 9)),
                                    float(rng.random()), 5.0))
        got = F.find_best_family_matches_batch(
            bests, n_per, fam, cnt, wt, first, mapping, thr, allow_ambig,
            tg, genus_filter)
        row_off = np.zeros(S + 1, dtype=np.int64)
        np.cumsum(n_per, out=row_off[1:])
        for s in range(S):
            a, b = int(row_off[s]), int(row_off[s + 1])
            sub = np.argsort(first[a:b], kind="stable")
            seq_score = {int(fam[a + i]): F.SeqScore(int(cnt[a + i]),
                                                     int(cnt[a + i]),
                                                     np.float32(wt[a + i]))
                         for i in sub}
            want = F.find_best_family_match(bests[s], seq_score, mapping,
                                            thr, allow_ambig, tg,
                                            genus_filter)
            g = got[s]
            assert (g.gfam_id, g.lfam_id, g.function) == \
                (want.gfam_id, want.lfam_id, want.function), (trial, s)
            assert g.gfam_score == want.gfam_score, (trial, s)
            assert g.lfam_score == want.lfam_score, (trial, s)


def test_reduction_best_match_parity():
    """The array-form best-call reduction (BestCallReduction) through
    find_best_family_matches_batch must equal the finish_best_call ->
    BestCall-list path exactly, including ambiguous and no-call rows."""
    from close_kmers_tpu.core.engine import finish_best_call
    from close_kmers_tpu.db.family_db import FamilyData

    rng = np.random.default_rng(123)
    for trial in range(40):
        n_funcs = int(rng.integers(2, 8))
        functions = [f"fn{i}" for i in range(n_funcs)]
        F_n = int(rng.integers(1, 24))
        mapping = KmerFamilyMapping()
        mapping.families = [
            FamilyData(f"PGF_{rng.integers(0, 6):05d}", f"PLF_{f:05d}",
                       int(rng.integers(0, 3)),
                       rng.choice(functions + ["hypothetical protein"]),
                       f, 5, 5)
            for f in range(F_n)]
        S = int(rng.integers(1, 12))
        # random native-reduction outputs: nf in 0..3, counts descending,
        # values straddling the 5.0 call/pair thresholds
        nf = rng.integers(0, 4, size=S).astype(np.int32)
        ocnt = np.sort(rng.integers(0, 12, size=(S, 3)), axis=1)[:, ::-1] \
            .astype(np.int32)
        ofi = rng.integers(0, n_funcs, size=(S, 3)).astype(np.int32)
        owt = rng.random((S, 3)).astype(np.float32)
        n_per = rng.integers(0, min(8, F_n + 2), size=S)
        N = int(n_per.sum())
        fam = np.concatenate([
            rng.choice(np.arange(-1, F_n + 1), size=n, replace=False)
            for n in n_per]).astype(np.int32) if N else np.zeros(0, np.int32)
        cnt = rng.integers(1, 7, size=N).astype(np.int32)
        wt = rng.choice(np.float32([0.0, 0.25, 0.5, 0.5, 1.5]), size=N)
        first = rng.permutation(N).astype(np.int32)
        allow_ambig = bool(rng.integers(0, 2))
        genus_filter = bool(rng.integers(0, 2))
        thr = int(rng.integers(1, 4))
        tg = int(rng.integers(0, 3))

        function_of = lambda i: (functions[i] if 0 <= i < n_funcs
                                 else "INVALID_OFFSET")
        bests = [finish_best_call(int(nf[s]), ofi[s], ocnt[s], owt[s],
                                  function_of) for s in range(S)]
        red = F.BestCallReduction(nf, ofi, ocnt, owt, functions)
        want = F.find_best_family_matches_batch(
            bests, n_per, fam, cnt, wt, first, mapping, thr, allow_ambig,
            tg, genus_filter)
        got = F.find_best_family_matches_batch(
            red, n_per, fam, cnt, wt, first, mapping, thr, allow_ambig,
            tg, genus_filter)
        for s in range(S):
            g, w = got[s], want[s]
            assert (g.gfam_id, g.lfam_id, g.function) == \
                (w.gfam_id, w.lfam_id, w.function), (trial, s)
            assert g.gfam_score == w.gfam_score, (trial, s)
            assert g.lfam_score == w.lfam_score, (trial, s)
            assert g.score == w.score and \
                g.weighted_score == w.weighted_score, (trial, s)


def test_best_match_columns_match_objects():
    """as_arrays=True must agree with the BestMatch-object path row for
    row (including materialization)."""
    import dataclasses
    from close_kmers_tpu.core.family import (BestCallReduction,
                                             find_best_family_matches_batch)
    from close_kmers_tpu.db.family_db import FamilyData, KmerFamilyMapping

    rng = np.random.default_rng(3)
    S, n_funcs = 400, 50
    mapping = KmerFamilyMapping()
    mapping.families = [
        FamilyData(f"PGF_{f:08d}", f"PLF_{f%5}_{f:08d}", f % 5,
                   f"fn{f//3}", f, 10, 10) for f in range(3 * n_funcs)]
    functions = [f"fn{i}" for i in range(n_funcs)]
    nf = rng.integers(0, 3, size=S).astype(np.int32)
    ofi = rng.integers(0, n_funcs, size=(S, 3)).astype(np.int32)
    ocnt = np.sort(rng.integers(0, 40, size=(S, 3)).astype(np.int32))[:, ::-1]
    owt = np.sort(rng.uniform(0, 20, size=(S, 3)).astype(np.float32))[:, ::-1]
    bests = BestCallReduction(nf, ofi, np.ascontiguousarray(ocnt),
                              np.ascontiguousarray(owt), functions)
    n_per = rng.integers(0, 5, size=S).astype(np.int32)
    total = int(n_per.sum())
    fam = rng.integers(0, 3 * n_funcs, size=total).astype(np.int32)
    cnt = rng.integers(1, 30, size=total).astype(np.int32)
    wt = rng.uniform(0, 5, size=total).astype(np.float32)
    first = rng.integers(0, 8000, size=total).astype(np.int32)

    objs = find_best_family_matches_batch(
        bests, n_per, fam, cnt, wt, first, mapping, genus_filter=False)
    cols = find_best_family_matches_batch(
        bests, n_per, fam, cnt, wt, first, mapping, genus_filter=False,
        as_arrays=True)
    assert len(cols) == len(objs)
    assert np.allclose(cols.score, [m.score for m in objs])
    assert np.allclose(cols.gfam_score, [m.gfam_score for m in objs])
    for i in range(S):
        assert dataclasses.astuple(cols.materialize(i)) == \
            dataclasses.astuple(objs[i]), i
