"""ctypes bindings for the native runtime (libckmers.so).

Provides batch scoring (the sequential run/gap/two-hit state machine),
best-call top-3 reduction, CSR family-score accumulation, and the
single-core baseline pipeline.  All semantics mirror the CPU oracle; see
ckmers.cpp for the reference citations.
"""

from __future__ import annotations

import ctypes as C

import numpy as np

from ..params import HIT_BUFFER_CAP
from .build import build

_lib = None


def lib():
    global _lib
    if _lib is None:
        _lib = C.CDLL(build())
        _lib.ck_family_scores.restype = C.c_int64
        _lib.ck_probe_seq.restype = C.c_int
    return _lib


def _p(a, t):
    return a.ctypes.data_as(C.POINTER(t))


def _i32(a):
    return np.ascontiguousarray(a, dtype=np.int32)


def _i64(a):
    return np.ascontiguousarray(a, dtype=np.int64)


def _f32(a):
    return np.ascontiguousarray(a, dtype=np.float32)


def score_batch(pos, fi, oi, avg_off, wt, row_off, params,
                max_calls_per_seq: int = 512, want_votes: bool = False):
    """Run the scoring state machine over concatenated per-sequence hit
    arrays.  Returns (n_calls[n_seqs], start, end, count, call_fi, call_wt
    as [n_seqs, max_calls_per_seq] arrays, votes or None)."""
    pos, fi, oi, avg_off = _i32(pos), _i32(fi), _i32(oi), _i32(avg_off)
    wt, row_off = _f32(wt), _i64(row_off)
    n_seqs = len(row_off) - 1
    n_calls = np.zeros(n_seqs, dtype=np.int32)
    shape = (n_seqs, max_calls_per_seq)
    cs = np.zeros(shape, dtype=np.int32)
    ce = np.zeros(shape, dtype=np.int32)
    cc = np.zeros(shape, dtype=np.int32)
    cf = np.zeros(shape, dtype=np.int32)
    cw = np.zeros(shape, dtype=np.float32)
    votes = np.zeros(len(pos), dtype=np.uint8) if want_votes else None
    lib().ck_score_batch(
        _p(pos, C.c_int32), _p(fi, C.c_int32), _p(oi, C.c_int32),
        _p(avg_off, C.c_int32), _p(wt, C.c_float), _p(row_off, C.c_int64),
        C.c_int(n_seqs), C.c_int32(params.order_constraint),
        C.c_int32(params.min_hits), C.c_int32(params.min_weighted_hits),
        C.c_int32(params.max_gap), C.c_int32(HIT_BUFFER_CAP),
        _p(n_calls, C.c_int32), _p(cs, C.c_int32), _p(ce, C.c_int32),
        _p(cc, C.c_int32), _p(cf, C.c_int32), _p(cw, C.c_float),
        C.c_int32(max_calls_per_seq),
        _p(votes, C.c_uint8) if votes is not None else None)
    return n_calls, cs, ce, cc, cf, cw, votes


def best_call_batch(n_calls, cs, ce, cc, cf, cw):
    """Top-3 per-function reduction for find_best_call; returns
    (n_funcs[n_seqs], fi[n_seqs,3], count[n_seqs,3], wt[n_seqs,3]).
    ``cs``/``ce`` may be None (the slim calls pack): the C reduction
    never reads call positions (kguts.cc:1023-1139 collapses on fi and
    sums counts/weights only), so the count plane stands in."""
    if cs is None:
        cs = ce = cc
    n_seqs, max_calls = cs.shape
    nf = np.zeros(n_seqs, dtype=np.int32)
    ofi = np.zeros((n_seqs, 3), dtype=np.int32)
    ocnt = np.zeros((n_seqs, 3), dtype=np.int32)
    owt = np.zeros((n_seqs, 3), dtype=np.float32)
    lib().ck_best_call_batch(
        _p(_i32(n_calls), C.c_int32), _p(cs, C.c_int32), _p(ce, C.c_int32),
        _p(cc, C.c_int32), _p(cf, C.c_int32), _p(cw, C.c_float),
        C.c_int32(max_calls), C.c_int(n_seqs),
        _p(nf, C.c_int32), _p(ofi, C.c_int32), _p(ocnt, C.c_int32),
        _p(owt, C.c_float))
    return nf, ofi, ocnt, owt


def family_scores(codes, row_off, keys, offs, vals):
    """Per-sequence family score accumulation against a CSR kmer→family
    map.  Returns (out_n[n_seqs], fam, hits, weighted) flattened in
    per-sequence first-insertion order."""
    codes, row_off = _i64(codes), _i64(row_off)
    keys, offs, vals = _i64(keys), _i64(offs), _i32(vals)
    n_seqs = len(row_off) - 1
    cap = max(1024, 4 * len(codes) + 16)
    while True:
        out_n = np.zeros(n_seqs, dtype=np.int32)
        fam = np.zeros(cap, dtype=np.int32)
        hits = np.zeros(cap, dtype=np.int32)
        weight = np.zeros(cap, dtype=np.float32)
        total = lib().ck_family_scores(
            _p(codes, C.c_int64), _p(row_off, C.c_int64), C.c_int(n_seqs),
            _p(keys, C.c_int64), _p(offs, C.c_int64), _p(vals, C.c_int32),
            C.c_int64(len(keys)), _p(out_n, C.c_int32), _p(fam, C.c_int32),
            _p(hits, C.c_int32), _p(weight, C.c_float), C.c_int64(cap))
        if total >= 0:
            return out_n, fam[:total], hits[:total], weight[:total]
        cap *= 4


_PRIMES = [3769, 6337, 12791, 24571, 51043, 101533, 206933, 400187,
           821999, 2000003, 4000037, 8000009, 16000057, 32000011,
           64000031, 128000003, 248000009, 508000037, 1073741824,
           1400303159, 2147483648,
           # extensions beyond the reference's ladder so the prime>3n
           # sizing rule (build_signature_kmers.cc:862-884) holds at the
           # ~1e9-key scale its own table never reached (kguts.h:259
           # fell back to 2^31/2^30 bucket experiments there)
           2912934743, 4000000007]


class HashPipeline:
    """Reference-architecture CPU baseline: kguts-style open-addressed
    hash (24B entries, linear probing, first prime > 3n buckets)."""

    def __init__(self, db):
        l = lib()
        l.ck_hash_build.restype = C.c_void_p
        n = len(db.keys)
        self.size_hash = next(p for p in _PRIMES if p > 3 * n)
        self._tab = l.ck_hash_build(
            _p(_i64(db.keys), C.c_int64), _p(_i32(db.fi), C.c_int32),
            _p(_i32(db.oi), C.c_int32), _p(_i32(db.avg_off), C.c_int32),
            _p(_f32(db.wt), C.c_float), C.c_int64(n),
            C.c_int64(self.size_hash))

    def run(self, offsets, lengths, min_hits=5, max_gap=200):
        offsets = np.ascontiguousarray(offsets, dtype=np.uint8)
        lengths = _i32(lengths)
        n_seqs, stride = offsets.shape
        out = np.zeros(n_seqs, dtype=np.int32)
        lib().ck_pipeline_hash(
            C.c_void_p(self._tab), C.c_int64(self.size_hash),
            _p(offsets, C.c_uint8), _p(lengths, C.c_int32),
            C.c_int(n_seqs), C.c_int(stride),
            C.c_int32(min_hits), C.c_int32(max_gap), _p(out, C.c_int32))
        return out

    def __del__(self):
        try:
            lib().ck_hash_free(C.c_void_p(self._tab))
        except Exception:
            pass


class PegMapRef:
    """kmer->peg CSR preloaded into an unordered_map (the reference's
    resident KmerPegMapping, kmer.h:77-101) for the matrix baseline."""

    def __init__(self, keys, offs, vals):
        l = lib()
        l.ck_pegmap_build.restype = C.c_void_p
        self._m = l.ck_pegmap_build(
            _p(_i64(keys), C.c_int64), _p(_i64(offs), C.c_int64),
            _p(_i64(vals), C.c_int64), C.c_int64(len(keys)))

    def __del__(self):
        try:
            lib().ck_pegmap_free(C.c_void_p(self._m))
        except Exception:
            pass


def matrix_hash(hp, pegmap, offsets, lengths):
    """Single-core /matrix on the reference architecture: hash probe +
    per-hit peg-list walk + std::map pair counts (matrix_request.cc:
    83-161).  Returns (n_pairs, total_shared)."""
    l = lib()
    l.ck_matrix_hash.restype = C.c_int64
    offsets = np.ascontiguousarray(offsets, dtype=np.uint8)
    n_seqs, stride = offsets.shape
    shared = C.c_int64(0)
    n_pairs = l.ck_matrix_hash(
        C.c_void_p(hp._tab), C.c_int64(hp.size_hash),
        C.c_void_p(pegmap._m), _p(offsets, C.c_uint8),
        _p(_i32(lengths), C.c_int32), C.c_int(n_seqs), C.c_int(stride),
        C.byref(shared))
    return int(n_pairs), int(shared.value)


def pipeline_batch(db, offsets, lengths, min_hits=5, max_gap=200):
    """Single-core encode+probe+score over a padded uint8 batch, using the
    same two-level index layout as the device probe.  Returns per-seq call
    counts.  This is the reference-architecture baseline for bench.py."""
    bucket_start = _i32(db.bucket_start)
    lo = _i32(db.lo)
    fi = _i32(db.fi)
    oi = _i32(db.oi)
    off = _i32(db.avg_off)
    wt = _f32(db.wt)
    offsets = np.ascontiguousarray(offsets, dtype=np.uint8)
    lengths = _i32(lengths)
    n_seqs, stride = offsets.shape
    out = np.zeros(n_seqs, dtype=np.int32)
    lib().ck_pipeline_batch(
        _p(bucket_start, C.c_int32), _p(lo, C.c_int32), _p(fi, C.c_int32),
        _p(oi, C.c_int32), _p(off, C.c_int32), _p(wt, C.c_float),
        _p(offsets, C.c_uint8), _p(lengths, C.c_int32),
        C.c_int(n_seqs), C.c_int(stride),
        C.c_int32(min_hits), C.c_int32(max_gap), _p(out, C.c_int32))
    return out
