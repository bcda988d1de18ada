"""On-device family-score rollup.

The /lookup family path accumulates, per sequence, {family: (hit_count,
weighted_total += 1/N)} over every signature-kmer hit
(/root/reference/lookup_request.cc:446-469).  The host path ships compact
hit lists off-device first (~KBs per protein); this module keeps the
rollup on device so only the per-(sequence, family) score triples leave
the chip:

1. the kmer→family CSR is densified to a degree-padded [N+1, D] int32
   table aligned to the signature DB rows (D = max families per kmer);
   the 1/N degree weight is recomputed on device from the row's non-pad
   count (bit-identical to an IEEE f32 1/n table lookup, one less
   gather op);
2. the probe's matched row index gathers each hit's family row; each
   SEQUENCE's (family, weight) stream is sorted along the window axis
   (a batched row-local sort — far cheaper than the global
   [B*W*D]-element sort it replaced), then grouped by a short
   lax.scan over the W*D sorted columns, and compacted per row.

Exactness: hit counts are integer-exact.  The row sort is stable with
the family id as the only key, so within a family group the elements
stay in (window position, family-list) order — exactly the order the
host path (native.family_scores) visits them — and the grouping scan
accumulates weighted_total with strictly-sequential f32 adds.  The
device rollup is therefore bit-identical to the host accumulation.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..db.signature_db import SignatureDB
from .engine import DeviceDB, encode_windows, probe_windows

# D2H fold constants — the single source for both the device-side packs
# and the host unpackers (a desync silently corrupts parsed results, so
# every shift/threshold below must come from here; see pack_flags):
# * slim CALL pack plane = (count << CALL_FOLD_SHIFT) | fi, legal when
#   counts fit CALL_CNT_BITS (count <= W+1) and fi fits CALL_FOLD_SHIFT
#   bits (CALL_CNT_BITS + CALL_FOLD_SHIFT = 31 keeps the sign bit clear);
# * rollup pack plane = (count << ROW_FOLD_SHIFT) | first, legal when
#   both fit ROW_FIT_BITS (count, first <= W*D+1; one spare bit below
#   ROW_FOLD_SHIFT keeps count << 16 under bit 31).
CALL_FOLD_SHIFT = 18
CALL_CNT_BITS = 13
ROW_FOLD_SHIFT = 16
ROW_FIT_BITS = 15


@dataclasses.dataclass
class DeviceFamilyDB:
    fam: jax.Array      # i32[N+1, D] family ids, -1 padded
    d: int

    # famwide probe-row gate: the folded table costs H*(3+D)*W*4 bytes,
    # which is H-dominated waste for small DBs — auto-on only at scale,
    # and only while the table fits this share of the device's memory
    FAMWIDE_SHARE = 3 / 16
    FAMWIDE_MAX_D = 8
    FAMWIDE_MIN_KEYS = 1_000_000

    @classmethod
    def _dense_fam(cls, db: SignatureDB, mapping):
        """[N+1, D] densified per-DB-row family lists (-1 padded)."""
        keys, offs, vals = mapping.fam_csr()
        n = len(db)
        rows = np.searchsorted(db.keys, keys)
        ok = (rows < n) & (db.keys[np.minimum(rows, n - 1)] == keys) \
            if n else np.zeros(len(keys), bool)
        counts = (offs[1:] - offs[:-1])
        D = int(counts.max()) if len(counts) else 1
        D = max(D, 1)
        fam = np.full((n + 1, D), -1, dtype=np.int32)
        # vectorized densify: column j gets the j-th family of every kmer
        # whose degree exceeds j
        for j in range(D):
            m = ok & (counts > j)
            fam[rows[m], j] = vals[offs[:-1][m] + j]
        return fam, D

    @classmethod
    def from_mapping(cls, db: SignatureDB, mapping, device=None) -> "DeviceFamilyDB":
        fam, D = cls._dense_fam(db, mapping)
        put = functools.partial(jax.device_put, device=device)
        return cls(put(jnp.asarray(fam)), D)

    @classmethod
    def famwide_from_mapping(cls, db: SignatureDB, mapping, device=None,
                             force: bool | None = None):
        """Folded family probe rows: [(fi<<13|lo) xW | wt-bits xW |
        fam_0 xW .. fam_{D-1} xW] per hi bucket, lane-padded to a
        multiple of 128 ints, so the FUSED family program needs ONE
        gather total — no separate [N+1, D] family-row gather.  fi packs
        with lo exactly like the fused_wide scale layout
        (engine.DeviceDB.FUSED_LO_BITS; needs fi < 2^18), which keeps
        the row at (2+D)*W ints — 110 -> 128 lanes at the bench DB's
        D=3, W=22, where a 3-plane variant would need 132-int rows.
        oi/avg_off are not carried: the family
        path never reads oi, and avg_off only under order_constraint
        (callers fall back to the two-gather path then).  Returns
        (jax.Array [H, row_w], W, D) or None when a gate trips
        (``force=True`` overrides the byte/scale gates for tests,
        ``force=False`` disables)."""
        from .engine import DeviceDB as _DDB, device_memory_bytes
        if force is False:
            return None
        n = len(db)
        if not n:
            return None
        fi_max = int(db.fi.max())
        if fi_max >= (1 << (31 - _DDB.FUSED_LO_BITS)):
            return None                      # fi won't pack beside lo
        fam, D = cls._dense_fam(db, mapping)
        H = db.n_hi
        W = max(1, int(db.max_bucket))
        row_w = -(-((2 + D) * W) // 128) * 128
        # Depth gate: folding only makes sense at wide/fused-tier
        # bucket depths — a PATRIC-density shard (max bucket ~2k) with
        # a small hi span passes the BYTE gate but its (2+D)*2k-int
        # rows put every selection in the byte-bound gather class and
        # the program runs out of device memory at serving batch sizes.
        from .engine import DeviceDB as _GateDDB
        if force is None and (D > cls.FAMWIDE_MAX_D
                              or W > _GateDDB.FUSED_BUCKET_MAX
                              or n < cls.FAMWIDE_MIN_KEYS
                              or H * row_w * 4 > cls.FAMWIDE_SHARE
                              * device_memory_bytes(device)):
            return None
        tab = np.zeros((H, row_w), dtype=np.int32)
        tab[:, :W] = _DDB.FUSED_SENTINEL     # packed-plane sentinel
        rank = np.arange(n, dtype=np.int64) \
            - db.bucket_start[db.hi].astype(np.int64)
        base = db.hi.astype(np.int64) * row_w + rank
        flat = tab.reshape(-1)
        flat[base] = (db.fi.astype(np.int64) << _DDB.FUSED_LO_BITS) | db.lo
        flat[base + W] = db.wt.view(np.int32)
        for p in range(D):
            flat[base + (2 + p) * W] = fam[:n, p]
        put = functools.partial(jax.device_put, device=device)
        return put(jnp.asarray(tab)), W, D


def _gather_fams(fam_tab, idx):
    """[B, W] matched-row ids -> [B, W, D] family rows, with the flat
    gather count padded away from power-of-two-rich lengths (see
    engine._probe_count_pad).  Pad indices hit the
    tab's final all-pad row, then are sliced off."""
    from .engine import _probe_count_pad
    B, W = idx.shape
    nflat = B * W
    npad = _probe_count_pad(nflat)
    flat = idx.reshape(-1)
    if npad != nflat:
        flat = jnp.concatenate([
            flat, jnp.full(npad - nflat, fam_tab.shape[0] - 1, flat.dtype)])
    return fam_tab[flat][:nflat].reshape(B, W, -1)


def rollup_from_fams(fams, cap_seq: int, row_cap: int = 0):
    """Shared rollup core: [B, W, D] gathered family rows (-1 = pad/miss)
    -> per-sequence (family, count, weighted) triples.  Used by the
    single-chip jit below and by the sharded annotation step
    (parallel/sharding.py) after its cross-shard family merge.

    Returns a row-major int32 buffer [B, 1 + 4*cap_seq]: each row is
    [n_per_seq, fam*cap_seq, cnt*cap_seq, wt-bits*cap_seq, first*cap_seq]
    — row-major so a data-axis concat of per-shard results stays
    parseable.  ``first`` is each family's first-hit flat (window*D +
    list) position, letting hosts rebuild the reference's first-hit
    accumulation order (lookup_request.cc:446-469) exactly: downstream
    tie-breaking and PGF-rollup f32 ordering depend on it.

    ``cap_seq < 0`` selects GLOBAL compaction instead: a flat int32
    buffer [B + 4*(-cap_seq)] of n_per_seq ++ fam/cnt/wt-bits/first
    planes packed across the whole batch (parse with
    DeviceFamilyScorer.finish_rollup_global).

    ``row_cap > 0`` (global mode only) compacts hierarchically: per-row
    to ``row_cap`` entries first, then a flat argsort over the B*row_cap
    survivors instead of over all B*(W*D+1) emission flags (14.9M
    elements at B=16k) — a row-local argsort is cheaper than the flat
    one.  The packed
    output is bit-identical to the flat path whenever every row has
    <= row_cap groups; rows that overflow are detectable host-side
    (n_per_seq carries true counts — finish_rollup_global returns None
    so callers re-dispatch with a bigger row_cap).
    """
    B, W, D = fams.shape
    # 1/degree recomputed from the gathered row (degree = non-pad count);
    # saves the second gather op.  Selected from host-computed IEEE f32
    # constants (a static chain over deg in 1..D) rather than a device
    # divide — a device f32 division may be reciprocal-based and not
    # correctly rounded, and these weights must match the host path's
    # np.float32(1.0/n) bit-for-bit.
    deg = (fams >= 0).sum(axis=-1)
    w = jnp.zeros(deg.shape, jnp.float32)
    for k in range(1, D + 1):
        w = jnp.where(deg == k, jnp.float32(np.float32(1.0) / np.float32(k)),
                      w)

    BIG = jnp.int32(2 ** 30)
    fam_flat = fams.reshape(B, W * D)
    key = jnp.where(fam_flat >= 0, fam_flat, BIG)
    wt_flat = jnp.where(fam_flat >= 0,
                        jnp.broadcast_to(w[:, :, None], (B, W, D)
                                         ).reshape(B, W * D), 0.0)
    # Row-local stable sort by family id: pads (BIG) sink to the end and
    # within a family group the (window position, family-list) order is
    # preserved — the exact visit order of the host accumulation.  The
    # flat position rides along so each group knows its first hit.
    pos_flat = jnp.broadcast_to(
        jax.lax.broadcasted_iota(jnp.int32, (B, W * D), 1), (B, W * D))
    skey, swt, spos = jax.lax.sort((key, wt_flat, pos_flat), dimension=1,
                                   num_keys=1, is_stable=True)

    # Grouping scan over the sorted columns: sequential f32 adds per
    # group (bit-identical to the host path), one emission per group
    # close, final groups flushed in the extra column.  Init zeros derive
    # from the inputs so they carry the same varying-axes type under
    # shard_map (see device_score._scan_score).
    zero = jnp.zeros_like(fams[:, 0, 0], dtype=jnp.int32)
    zf = jnp.zeros_like(w[:, 0], dtype=jnp.float32)

    def step(s, x):
        cur, cnt, ws, first, have = s
        f, wv, pv = x
        valid_c = f < BIG
        is_new = valid_c & (~have | (f != cur))
        same = valid_c & have & (f == cur)
        emit = is_new & have
        y = (emit, cur, cnt, ws, first)
        return (jnp.where(is_new, f, cur),
                jnp.where(is_new, 1, jnp.where(same, cnt + 1, cnt)),
                jnp.where(is_new, wv, jnp.where(same, ws + wv, ws)),
                jnp.where(is_new, pv, first),
                have | valid_c), y

    (f_cur, f_cnt, f_ws, f_first, f_have), ys = jax.lax.scan(
        step, (zero, zero, zf, zero, zero != 0), (skey.T, swt.T, spos.T))
    emit = jnp.concatenate([ys[0].T, f_have[:, None]], axis=1)  # [B, WD+1]
    famc = jnp.concatenate([ys[1].T, f_cur[:, None]], axis=1)
    cntc = jnp.concatenate([ys[2].T, f_cnt[:, None]], axis=1)
    wsc = jnp.concatenate([ys[3].T, f_ws[:, None]], axis=1)
    firstc = jnp.concatenate([ys[4].T, f_first[:, None]], axis=1)

    if cap_seq < 0:
        # Global compaction to [4, -cap_seq] (the calls-pack pattern):
        # a flat stable argsort keeps row-major order, so entries stay
        # grouped by sequence — n_per_seq delimits rows on the host.
        # D2H scales with the number of (sequence, family) groups, not
        # B * max-groups-per-row; this is what the fq/tiny-ORF regime
        # needs, where the dense rows buffer dominates the D2H copy.
        gcap = -cap_seq
        n_per_seq = emit.sum(axis=1, dtype=jnp.int32)
        # D2H slimming: when every (count, first-hit-position) pair fits
        # 15+16 bits — W*D+1 < 2^15, true for all protein-serving shapes
        # — fold them into ONE plane: the global pack ships 3 planes
        # instead of 4 (the rows pack is the largest family-path D2H
        # buffer).  finish_rollup_global
        # splits them back (folded=True).
        fold = (W * D + 1) < (1 << ROW_FIT_BITS)
        if row_cap > 0:
            R = row_cap
            order = jnp.argsort(~emit, axis=1, stable=True)[:, :R]
            fam_d = jnp.take_along_axis(famc, order, axis=1)
            cnt_d = jnp.take_along_axis(cntc, order, axis=1)
            ws_d = jnp.take_along_axis(wsc, order, axis=1)
            first_d = jnp.take_along_axis(firstc, order, axis=1)
            emit2 = (jax.lax.broadcasted_iota(jnp.int32, (B, R), 1)
                     < jnp.minimum(n_per_seq, R)[:, None]).reshape(-1)
            order2 = jnp.argsort(~emit2, stable=True)[:gcap]
            planes = [fam_d.reshape(-1)[order2]]
            if fold:
                planes.append(
                    (cnt_d.reshape(-1)[order2] << ROW_FOLD_SHIFT)
                    | first_d.reshape(-1)[order2])
            else:
                planes.append(cnt_d.reshape(-1)[order2])
            planes.append(jax.lax.bitcast_convert_type(
                ws_d.reshape(-1)[order2], jnp.int32))
            if not fold:
                planes.append(first_d.reshape(-1)[order2])
            return jnp.concatenate([n_per_seq, jnp.stack(planes)
                                    .reshape(-1)])
        flat_emit = emit.reshape(-1)
        order = jnp.argsort(~flat_emit, stable=True)[:gcap]
        planes = [famc.reshape(-1)[order]]
        if fold:
            planes.append((cntc.reshape(-1)[order] << ROW_FOLD_SHIFT)
                          | firstc.reshape(-1)[order])
        else:
            planes.append(cntc.reshape(-1)[order])
        planes.append(jax.lax.bitcast_convert_type(wsc.reshape(-1)[order],
                                                   jnp.int32))
        if not fold:
            planes.append(firstc.reshape(-1)[order])
        return jnp.concatenate([n_per_seq, jnp.stack(planes).reshape(-1)])

    # Per-row compaction to [B, cap_seq]: emitted groups are already in
    # ascending-family column order, so a stable argsort on ~emit packs
    # them left in that order.
    n_per_seq = emit.sum(axis=1, dtype=jnp.int32)
    order = jnp.argsort(~emit, axis=1, stable=True)[:, :cap_seq]
    fam_d = jnp.take_along_axis(famc, order, axis=1)
    cnt_d = jnp.take_along_axis(cntc, order, axis=1)
    ws_d = jnp.take_along_axis(wsc, order, axis=1)
    first_d = jnp.take_along_axis(firstc, order, axis=1)
    return jnp.concatenate(
        [n_per_seq[:, None], fam_d, cnt_d,
         jax.lax.bitcast_convert_type(ws_d, jnp.int32), first_d], axis=1)


@functools.partial(jax.jit,
                   static_argnames=("cap_seq", "wide_w", "sub_w", "fused_w"))
def _family_rollup_jit(bucket_pair, lo_arr, payload,
                       n, n_steps, fam_tab, offsets, lengths, cap_seq,
                       lo_wide=None, payload_wide=None, wide_w=0,
                       sub_header=None, sub_blocks=None, sub_w=0,
                    fused_wide=None, fused_w=0):
    ddb = DeviceDB(bucket_pair, lo_arr, payload, n_steps, n, lo_wide,
                   payload_wide, wide_w, sub_header, sub_blocks, sub_w,
                   fused_wide, fused_w)
    hi, lo, valid = encode_windows(offsets, lengths)
    found, _fi, _oi, _av, _wt, idx = probe_windows(ddb, hi, lo, valid)
    fams = _gather_fams(fam_tab, idx)        # [B, W, D]
    rows = rollup_from_fams(fams, cap_seq)
    # legacy flat layout (single packed D2H buffer): [B n_per_seq] ++
    # [B*cap fam] ++ [B*cap cnt] ++ [B*cap wt-bits] ++ [B*cap first]
    c = cap_seq
    return jnp.concatenate([
        rows[:, 0], rows[:, 1:1 + c].reshape(-1),
        rows[:, 1 + c:1 + 2 * c].reshape(-1),
        rows[:, 1 + 2 * c:1 + 3 * c].reshape(-1),
        rows[:, 1 + 3 * c:].reshape(-1)])


@functools.partial(
    jax.jit,
    static_argnames=("min_hits", "min_weighted_hits", "max_gap",
                     "order_constraint", "call_cap", "cap_seq", "wide_w",
                     "sub_w", "fused_w", "slim_calls", "row_cap",
                     "fam_w", "fam_d", "fold_calls"))
def _score_family_jit(bucket_pair, lo_arr, payload, n, n_steps, fam_tab,
                      offsets, lengths, min_hits, min_weighted_hits,
                      max_gap, order_constraint, call_cap, cap_seq,
                      lo_wide=None, payload_wide=None, wide_w=0,
                      sub_header=None, sub_blocks=None, sub_w=0,
                    fused_wide=None, fused_w=0, slim_calls=False,
                    row_cap=0, famwide=None, fam_w=0, fam_d=0,
                    fold_calls=False):
    """The family-serving program: ONE probe feeding both the scoring
    scan (packed CALL buffer, same layout as device_score._probe_score_jit)
    and the family rollup (packed rows).  /lookup?find_best_match=1 needs
    both, so fusing them halves the dominant gather cost.

    ``slim_calls`` drops the start/end planes from the CALL pack (3
    planes instead of 5): the best-match path feeds the pack only to the
    native best-call reduction, which never reads call positions
    (ckmers.cpp ck_best_call_batch; kguts.cc:1023-1139 uses counts and
    weights only) — a 40% cut of the calls D2H."""
    from .device_score import _scan_score

    hi, lo, valid = encode_windows(offsets, lengths)
    if famwide is not None:
        # Folded single-gather path (famwide_from_mapping): the row
        # carries (fi<<13|lo)/wt AND the family lists, so neither the
        # payload-wide probe nor the separate fam-row gather runs.
        # avg_off is not carried — callers guarantee
        # order_constraint=False on this path.
        from .engine import DeviceDB as _DDB
        from .engine import _pad_flat_probes, _unpad_sel
        assert not order_constraint
        sh = hi.shape
        hi_c = jnp.where(valid, hi, 0)
        lo_c = jnp.where(valid, lo, -2)
        hif, lof, nflat = _pad_flat_probes(hi_c.reshape(-1),
                                           lo_c.reshape(-1))
        row = famwide[hif]
        Wd = fam_w
        LMASK = (1 << _DDB.FUSED_LO_BITS) - 1
        packed = row[:, :Wd]
        match = (packed & LMASK) == (lof[:, None] & LMASK)
        foundf = match.any(axis=-1)
        m = match.astype(jnp.int32)

        def pick(p):
            return (row[:, p * Wd:(p + 1) * Wd] * m).sum(axis=-1)

        fif_packed = (packed * m).sum(axis=-1) >> _DDB.FUSED_LO_BITS
        sel = _unpad_sel((foundf, fif_packed, pick(1))
                         + tuple(pick(2 + p) for p in range(fam_d)), nflat)
        found = valid & sel[0].reshape(sh)
        p_fi = jnp.where(found, sel[1].reshape(sh), -1)
        p_wt = jax.lax.bitcast_convert_type(
            jnp.where(found, sel[2].reshape(sh), 0), jnp.float32)
        p_av = jnp.zeros_like(p_fi)
        fams = jnp.stack([jnp.where(found, sel[3 + p].reshape(sh), -1)
                          for p in range(fam_d)], axis=-1)
    else:
        ddb = DeviceDB(bucket_pair, lo_arr, payload, n_steps, n, lo_wide,
                       payload_wide, wide_w, sub_header, sub_blocks, sub_w,
                       fused_wide, fused_w)
        found, p_fi, _oi, p_av, p_wt, idx = probe_windows(ddb, hi, lo,
                                                          valid)
        fams = None

    emit, (c_start, c_end, c_cnt, c_fi, c_wt) = _scan_score(
        found, p_fi, p_av, p_wt, min_hits, min_weighted_hits, max_gap,
        order_constraint)
    n_calls = emit.sum(axis=1, dtype=jnp.int32)
    flat_emit = emit.reshape(-1)
    order = jnp.argsort(~flat_emit, stable=True)[:call_cap]
    planes = [] if slim_calls else [
        c_start.reshape(-1)[order].astype(jnp.int32),
        c_end.reshape(-1)[order].astype(jnp.int32),
    ]
    if slim_calls and fold_calls:
        # (count << CALL_FOLD_SHIFT) | fi in one plane: callers
        # guarantee statically that counts fit CALL_CNT_BITS (W+1) and fi
        # CALL_FOLD_SHIFT bits — the slim CALL pack drops to 2 planes
        # (unpack with unpack_dense2)
        planes += [
            (c_cnt.reshape(-1)[order].astype(jnp.int32) << CALL_FOLD_SHIFT)
            | c_fi.reshape(-1)[order].astype(jnp.int32),
            jax.lax.bitcast_convert_type(c_wt.reshape(-1)[order],
                                         jnp.int32),
        ]
    else:
        planes += [
            c_cnt.reshape(-1)[order].astype(jnp.int32),
            c_fi.reshape(-1)[order].astype(jnp.int32),
            jax.lax.bitcast_convert_type(c_wt.reshape(-1)[order],
                                         jnp.int32),
        ]
    calls_out = jnp.concatenate([n_calls, jnp.stack(planes).reshape(-1)])

    if fams is None:
        fams = _gather_fams(fam_tab, idx)
    rows = rollup_from_fams(fams, cap_seq, row_cap)
    return calls_out, rows


class DeviceFamilyScorer:
    """Fused probe + family rollup engine."""

    def __init__(self, db: SignatureDB, mapping, device=None, ddb=None,
                 famwide: bool | None = False):
        """``ddb``: share an existing DeviceDB (e.g. the serving
        engine's) instead of re-uploading the signature arrays.
        ``famwide``: folded single-gather family rows — folding saves
        the narrow fam-row gather but doubles the probe row's gathered
        bytes, so the default is OFF; True forces it on (parity tests),
        None = auto byte/scale gate."""
        self.db = db
        self.ddb = ddb if ddb is not None else DeviceDB.from_db(
            db, device=device)
        self.fdb = DeviceFamilyDB.from_mapping(db, mapping, device=device)
        fw = DeviceFamilyDB.famwide_from_mapping(db, mapping, device=device,
                                                 force=famwide)
        self.famwide, self.fam_w, self.fam_d = fw if fw is not None \
            else (None, 0, 0)
        self._fi_fold_ok = (int(db.fi.max()) < (1 << CALL_FOLD_SHIFT)) \
            if len(db) else True

    def rollup(self, offsets: np.ndarray, lengths: np.ndarray,
               fams_per_seq_cap: int | None = None):
        if fams_per_seq_cap is None:
            # sticky: an overflow escalation re-raises the default so the
            # capf recompile cliff is paid once per scorer, not per batch
            fams_per_seq_cap = self._default_cap
        return self._rollup(offsets, lengths, fams_per_seq_cap)

    _default_cap = 8

    def rollup_packed(self, offsets: np.ndarray, lengths: np.ndarray,
                      fams_per_seq_cap: int | None = None):
        """Async variant: dispatches the fused rollup and returns the
        un-transferred packed device buffer plus capf, so callers can
        pipeline dispatch against readback.  Unpack with finish_rollup
        (None result = cap overflow, re-dispatch with a bigger cap)."""
        if fams_per_seq_cap is None:
            fams_per_seq_cap = self._default_cap
        d = self.ddb
        out = _family_rollup_jit(
            d.bucket_pair, d.lo, d.payload, d.n,
            d.n_steps, self.fdb.fam,
            jnp.asarray(offsets), jnp.asarray(lengths), fams_per_seq_cap,
            d.lo_wide, d.payload_wide, d.wide_w, d.sub_header,
            d.sub_blocks, d.sub_w, d.fused_wide, d.fused_w)
        return out, fams_per_seq_cap

    @staticmethod
    def finish_rollup(out_np: np.ndarray, B: int, cap_seq: int):
        """Packed buffer -> (n_per_seq [B], fam, count, weight, first flat
        arrays in (sequence, family-id) order).  Returns None when any row
        overflowed cap_seq (caller retries with a bigger cap)."""
        n_per_seq = out_np[:B]
        if len(n_per_seq) and int(n_per_seq.max(initial=0)) > cap_seq:
            return None
        body = out_np[B:].reshape(4, B, cap_seq)
        mask = np.arange(cap_seq)[None, :] < n_per_seq[:, None]
        run_f = body[0][mask]
        counts = body[1][mask]
        weights = body[2][mask].copy().view(np.float32)
        first = body[3][mask]
        return n_per_seq, run_f, counts, weights, first

    @staticmethod
    def finish_rollup_rows(rows_np: np.ndarray, cap_seq: int):
        """Row-major rollup buffer (rollup_from_fams: [B, 1+4*cap_seq])
        -> same tuple as finish_rollup; None on per-row cap overflow."""
        n_per_seq = rows_np[:, 0]
        if len(n_per_seq) and int(n_per_seq.max(initial=0)) > cap_seq:
            return None
        mask = np.arange(cap_seq)[None, :] < n_per_seq[:, None]
        c = cap_seq
        run_f = rows_np[:, 1:1 + c][mask]
        counts = rows_np[:, 1 + c:1 + 2 * c][mask]
        weights = rows_np[:, 1 + 2 * c:1 + 3 * c][mask].copy() \
            .view(np.float32)
        first = rows_np[:, 1 + 3 * c:1 + 4 * c][mask]
        return n_per_seq, run_f, counts, weights, first

    @staticmethod
    def finish_rollup_global(flat_np: np.ndarray, B: int, gcap: int,
                             row_cap: int = 0, folded: bool = False):
        """Globally-packed rollup buffer (rollup_from_fams with negative
        cap: [B + 4*gcap], or [B + 3*gcap] when the device folded
        count|first into one plane — pass ``folded`` matching
        pack_flags) -> same tuple as finish_rollup; None when the
        batch's total group count overflows gcap, or (hierarchical
        packs) when any single row overflows row_cap."""
        n_per_seq = flat_np[:B]
        if row_cap > 0 and len(n_per_seq) \
                and int(n_per_seq.max(initial=0)) > row_cap:
            return None
        total = int(n_per_seq.sum())
        # Size from the buffer, not `gcap`: the device packs
        # min(gcap, B*(W*D+1)) entries (argsort slice clamps), so an
        # over-escalated gcap must not turn into a reshape ValueError.
        pack = flat_np[B:].reshape(3 if folded else 4, -1)
        if total > pack.shape[1]:
            return None
        t = slice(0, total)
        if folded:
            return (n_per_seq, pack[0, t],
                    pack[1, t] >> ROW_FOLD_SHIFT,
                    pack[2, t].copy().view(np.float32),
                    pack[1, t] & ((1 << ROW_FOLD_SHIFT) - 1))
        return (n_per_seq, pack[0, t], pack[1, t],
                pack[2, t].copy().view(np.float32), pack[3, t])

    def pack_flags(self, L: int) -> tuple[bool, bool]:
        """Static D2H-fold flags for a padded width L: (fold_calls —
        slim CALL pack ships (cnt<<18|fi, wt); fold_rows — rollup pack
        ships (fam, cnt<<16|first, wt)).  Must match what the device
        packed: the same arithmetic runs inside _score_family_jit /
        rollup_from_fams on the static shapes."""
        W = L - 8
        return (self._fi_fold_ok and (W + 1) < (1 << CALL_CNT_BITS),
                (W * self.fdb.d + 1) < (1 << ROW_FIT_BITS))

    def score_family_packed(self, offsets, lengths, params,
                            calls_per_seq_cap: int = 4,
                            fams_per_seq_cap: int | None = None,
                            slim_calls: bool = False, row_cap: int = 0):
        """Fused calls + family rollup (one probe, one dispatch).
        Returns (calls_dev, call_cap, rows_dev, cap_seq) — both device
        buffers un-transferred for pipelining.  calls_dev parses with
        device_score.DeviceScorer.unpack_dense (unpack_dense3 when
        slim_calls), rows_dev with finish_rollup_rows.  ``row_cap``:
        hierarchical global compaction (see rollup_from_fams); pass the
        same value to finish_rollup_global."""
        if fams_per_seq_cap is None:
            fams_per_seq_cap = self._default_cap
        d = self.ddb
        call_cap = offsets.shape[0] * calls_per_seq_cap
        # the folded rows carry no avg_off plane, which order_constraint
        # scoring needs — fall back to the two-gather path there
        use_fw = self.famwide is not None and not params.order_constraint
        fold_calls, _ = self.pack_flags(offsets.shape[1])
        calls_out, rows = _score_family_jit(
            d.bucket_pair, d.lo, d.payload, d.n, d.n_steps, self.fdb.fam,
            jnp.asarray(offsets), jnp.asarray(lengths),
            params.min_hits, params.min_weighted_hits, params.max_gap,
            params.order_constraint, call_cap, fams_per_seq_cap,
            d.lo_wide, d.payload_wide, d.wide_w, d.sub_header,
            d.sub_blocks, d.sub_w, d.fused_wide, d.fused_w, slim_calls,
            row_cap,
            self.famwide if use_fw else None,
            self.fam_w if use_fw else 0,
            self.fam_d if use_fw else 0,
            fold_calls and slim_calls)
        return calls_out, call_cap, rows, fams_per_seq_cap

    def _rollup(self, offsets: np.ndarray, lengths: np.ndarray,
                fams_per_seq_cap: int):
        """Returns (n_per_seq [B], fam, count, weight, first arrays
        concatenated in (sequence, family-id) order).  Within a sequence
        the entries are family-id-ordered (sort-based); use ``first``
        (first-hit flat position) to recover the host path's first-hit
        order."""
        B = offsets.shape[0]
        out, capf = self.rollup_packed(offsets, lengths, fams_per_seq_cap)
        res = self.finish_rollup(np.asarray(out), B, capf)
        if res is None:
            self._default_cap = max(self._default_cap, fams_per_seq_cap * 4)
            return self._rollup(offsets, lengths, fams_per_seq_cap * 4)
        return res
