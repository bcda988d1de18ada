"""On-device scoring: the gather_hits run/gap/two-hit state machine,
fused with the probe.

The reference's hot loop (kguts.cc:783-877) is sequential per sequence but
embarrassingly parallel across sequences: a scan whose carry is a vector
of per-sequence states.  Each scan step consumes one window position for
the whole batch and updates 13 [B]-shaped state fields with masked
selects.  On CUDA the scan runs as one Pallas kernel
(ops/pallas_scan.py); the ``lax.scan`` form here is its reference.

Shipping raw [B, W] probe results to host scoring would move every
window's planes to the host; scoring on device emits only the compacted
per-sequence CALL list (typically ~1-2 calls/sequence) packed into a
single int32 buffer.

Exactness: integer fields match the oracle exactly; weighted sums are
float32 additions in the same order the reference performs them
(process_set_of_hits re-sums the buffer in arrival order — incremental
accumulation in arrival order is the same sequence of f32 adds).  The
run-reseed quirk (kguts.cc:772-777), gap flush (821-831), order
constraint with its unsigned-wrap drift test (838-842), and the
two-in-a-row flush (852-856) are all replicated.  One structural lemma
makes the scan emission simple: at most ONE call can be emitted per
position (a gap flush and a two-in-a-row flush cannot both emit in the
same step, because a post-flush buffer is either empty or reseeded with
the new hit's own function).

The hit-buffer cap (kguts.cc:850-851) is not modeled; callers must keep
the padded width below HIT_BUFFER_CAP (39998), which every practical
batch satisfies.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..params import HIT_BUFFER_CAP, K, EngineParams
from .engine import DeviceDB, encode_windows, probe_windows


def _scan_score(found, h_fi, h_av, h_wt, min_hits, min_weighted_hits,
                max_gap, order_constraint):
    """found/h_fi/h_av/h_wt: [B, W].  Returns per-position call emissions
    ([B, W+1] fields; the final column is the end-of-sequence flush) and
    per-sequence call counts.

    The implementation follows the platform the program is lowered for:
    on CUDA the single-launch Pallas kernel (ops/pallas_scan.py), on
    every other platform the ``lax.scan`` reference."""
    from ..ops.pallas_scan import scan_score_pallas
    kw = dict(min_hits=min_hits, min_weighted_hits=min_weighted_hits,
              max_gap=max_gap, order_constraint=order_constraint)
    return jax.lax.platform_dependent(
        found, h_fi, h_av, h_wt,
        cuda=functools.partial(scan_score_pallas, **kw),
        default=functools.partial(_scan_score_xla, **kw))


def _scan_score_xla(found, h_fi, h_av, h_wt, min_hits, min_weighted_hits,
                    max_gap, order_constraint):
    """The scoring scan as a ``lax.scan`` over window positions: the
    reference the kernel is tested against."""
    emit, fields, _state = _scan_score_core(
        found, h_fi, h_av, h_wt, min_hits, min_weighted_hits, max_gap,
        order_constraint)
    return emit, fields


def neutral_scan_state(like_i32, like_f32):
    """The gather_hits state at sequence start (all-zero carry), derived
    from input arrays so the fields keep the callers' varying-axes type
    under shard_map."""
    zero = jnp.zeros_like(like_i32, dtype=jnp.int32)
    zf = jnp.zeros_like(like_f32, dtype=jnp.float32)
    return dict(
        num_hits=zero, current=zero, first_pos=zero,
        prev_fi=zero, prev_pos=zero, prev_av=zero, prev_wt=zf,
        prev2_fi=zero, prev2_pos=zero, prev2_wt=zf,
        cnt=zero, wsum=zf, last_match=zero,
    )


def _scan_score_core(found, h_fi, h_av, h_wt, min_hits, min_weighted_hits,
                     max_gap, order_constraint, init=None, pos0=None,
                     want_emit=True, final_flush=None):
    """The gather_hits state machine as a batched scan, generalized for
    chained tiles (the long-contig sequence-parallel path, SURVEY.md §5):

    * ``init`` — per-row carry state to resume from (default: the neutral
      sequence-start state).  The 13-field carry is the COMPLETE machine
      state (kguts.h:263-285 reduces to it when order_constraint admits
      everything or rejects by the last hit only), so threading a row's
      final state into the next tile's init reproduces the untiled scan
      exactly.
    * ``pos0`` — per-row global position of column 0 (default 0); all
      positions in the carry and emitted calls are pos0-relative-global,
      so gap tests work across tile boundaries.
    * ``want_emit=False`` — skip emission outputs (returns (None, None,
      state)); the fixpoint iterations of the genome path only need
      final carries.
    * ``final_flush`` — [B] bool: which rows perform the end-of-sequence
      flush (kguts.cc:873-877); interior tiles of a chained sequence
      must NOT flush (their state continues into the next tile).
    """
    B, W = found.shape
    if W >= HIT_BUFFER_CAP:
        raise ValueError("padded width exceeds the reference hit-buffer cap")

    i32 = jnp.int32
    f32 = jnp.float32
    # Derive the init zeros from the inputs so they carry the same
    # varying-axes type under shard_map (a plain jnp.zeros is unvarying
    # and trips the scan carry type check).
    zero = jnp.zeros_like(h_fi[:, 0], dtype=i32)
    zf = jnp.zeros_like(h_wt[:, 0], dtype=f32)

    init = init if init is not None else neutral_scan_state(
        h_fi[:, 0], h_wt[:, 0])
    pos_base = zero if pos0 is None else pos0.astype(i32)

    def flush_fields(s):
        """Emission test + call fields for process_set_of_hits
        (kguts.cc:752-755)."""
        emit = ((s["num_hits"] > 0) & (s["cnt"] >= min_hits)
                & (s["wsum"] >= jnp.float32(min_weighted_hits)))
        call = (s["first_pos"], s["last_match"] + (K - 1), s["cnt"],
                s["current"], s["wsum"])
        return emit, call

    def apply_flush(s, fire):
        """State transition of process_set_of_hits where ``fire``:
        reseed from the last two buffered hits or clear (kguts.cc:772-780)."""
        reseed = (fire & (s["num_hits"] >= 2)
                  & (s["prev2_fi"] != s["current"])
                  & (s["prev2_fi"] == s["prev_fi"]))
        clear = fire & ~reseed
        return dict(
            s,
            current=jnp.where(reseed, s["prev_fi"], s["current"]),
            num_hits=jnp.where(reseed, 2, jnp.where(clear, 0, s["num_hits"])),
            cnt=jnp.where(reseed, 2, jnp.where(clear, 0, s["cnt"])),
            wsum=jnp.where(reseed, s["prev2_wt"] + s["prev_wt"],
                           jnp.where(clear, zf, s["wsum"])),
            first_pos=jnp.where(reseed, s["prev2_pos"], s["first_pos"]),
            last_match=jnp.where(reseed, s["prev_pos"], s["last_match"]),
        )

    def step(s, x):
        h, fi, av, wt, pos = x
        posb = pos_base + pos

        # --- gap handling (kguts.cc:821-831)
        gap = h & (s["num_hits"] > 0) & (s["prev_pos"] + max_gap < posb)
        gf_flush = gap & (s["num_hits"] >= min_hits)
        gf_reset = gap & ~gf_flush
        emitA, callA = flush_fields(s)
        emitA = emitA & gf_flush
        s = apply_flush(s, gf_flush)
        s = dict(s,
                 num_hits=jnp.where(gf_reset, 0, s["num_hits"]),
                 cnt=jnp.where(gf_reset, 0, s["cnt"]),
                 wsum=jnp.where(gf_reset, zf, s["wsum"]))

        # --- current_fI seeding (kguts.cc:833-836)
        was0 = s["num_hits"] == 0
        cur = jnp.where(h & was0, fi, s["current"])

        # --- admission (kguts.cc:838-842): unsigned-wrap drift in [0, 20]
        if order_constraint:
            drift = (posb - s["prev_pos"]) - (s["prev_av"] - av)
            admit = h & (was0 | ((fi == s["prev_fi"])
                                 & (drift >= 0) & (drift <= 20)))
        else:
            admit = h

        # --- append (kguts.cc:844-851)
        match = fi == cur
        nh1 = s["num_hits"] + 1
        appended = dict(
            s,
            current=cur,
            num_hits=jnp.where(admit, nh1, s["num_hits"]),
            first_pos=jnp.where(admit & was0, posb, s["first_pos"]),
            cnt=jnp.where(admit & match, s["cnt"] + 1, s["cnt"]),
            wsum=jnp.where(admit & match, s["wsum"] + wt, s["wsum"]),
            last_match=jnp.where(admit & match, posb, s["last_match"]),
            prev2_fi=jnp.where(admit, s["prev_fi"], s["prev2_fi"]),
            prev2_pos=jnp.where(admit, s["prev_pos"], s["prev2_pos"]),
            prev2_wt=jnp.where(admit, s["prev_wt"], s["prev2_wt"]),
            prev_fi=jnp.where(admit, fi, s["prev_fi"]),
            prev_pos=jnp.where(admit, posb, s["prev_pos"]),
            prev_av=jnp.where(admit, av, s["prev_av"]),
            prev_wt=jnp.where(admit, wt, s["prev_wt"]),
        )
        s = dict(appended, current=jnp.where(h, cur, s["current"]))

        # --- two-in-a-row flush (kguts.cc:852-856)
        tir = (admit & (s["num_hits"] > 1) & (cur != fi)
               & (s["prev2_fi"] == fi))
        emitB, callB = flush_fields(s)
        emitB = emitB & tir
        s = apply_flush(s, tir)

        emit = emitA | emitB
        call = tuple(jnp.where(emitA, a, b) for a, b in zip(callA, callB))
        y = (emit,) + call if want_emit else None
        return s, y

    pos_seq = jnp.arange(W, dtype=i32)
    xs = (found.T, h_fi.T, h_av.T, h_wt.T, pos_seq)
    state, ys = jax.lax.scan(step, init, xs)
    if not want_emit:
        return None, None, state

    # end-of-sequence flush (kguts.cc:873-875)
    emitF, callF = flush_fields(state)
    emitF = emitF & (state["num_hits"] >= min_hits)
    if final_flush is not None:
        emitF = emitF & final_flush

    emit = jnp.concatenate([ys[0].T, emitF[:, None]], axis=1)     # [B, W+1]
    fields = [jnp.concatenate([y.T, c[:, None]], axis=1)
              for y, c in zip(ys[1:], callF)]
    return emit, fields, state


def _left_pack(valid, fields):
    """Per-row stable compaction: emitted entries move to the left,
    preserving order.  valid [B, M] bool; fields list of [B, M]."""
    order = jnp.argsort(~valid, axis=1, stable=True)
    packed = [jnp.take_along_axis(f, order, axis=1) for f in fields]
    n = valid.sum(axis=1, dtype=jnp.int32)
    return n, packed


def _best_call_device(emit, c_cnt, c_fi, c_wt):
    """find_best_call's reductions on device (kguts.cc:1008-1152):
    collapse adjacent same-function runs, bridge-merge F1|F2|F1, ascending
    per-function totals, and a literal replica of libstdc++
    partial_sort(first, first+2) including its tie behavior and the
    displaced element at index 2 (used by the ambiguous pair_offset).

    Inputs [B, M] from the scoring scan.  Returns per-row
    (n_funcs, fi0, cnt0, wt0, fi1, cnt1, wt1, cnt2) — everything the final
    (host-side, string-dependent) decision step needs.
    """
    B, M = emit.shape
    n_calls, (p_fi, p_cnt, p_wt) = _left_pack(emit, [c_fi, c_cnt, c_wt])
    # Real sequences emit a handful of calls; trim the packed stream so
    # the downstream scans run over CAPC steps instead of W.  Rows with
    # more calls are flagged for a host fallback (exactness preserved).
    CAPC = 32
    if M > CAPC:
        overflow = n_calls > CAPC
        p_fi = p_fi[:, :CAPC]
        p_cnt = p_cnt[:, :CAPC]
        p_wt = p_wt[:, :CAPC]
        n_calls = jnp.minimum(n_calls, CAPC)
        M = CAPC
    else:
        overflow = n_calls < 0  # all-false
    idx = jax.lax.broadcasted_iota(jnp.int32, (B, M), 1)
    valid = idx < n_calls[:, None]

    # Derived from the inputs so the scan carries keep the same
    # varying-axes type under shard_map (see _scan_score's init note).
    zero = jnp.zeros_like(n_calls, dtype=jnp.int32)
    zf = jnp.zeros_like(c_wt[:, 0], dtype=jnp.float32)

    # --- collapse adjacent same-fI (kguts.cc:1023-1040)
    def coll_step(s, x):
        have, cfi, ccnt, cwt = s
        v, fi, cnt, wt = x
        same = v & have & (fi == cfi)
        newg = v & (~have | (fi != cfi))
        y_emit = newg & have
        y = (y_emit, cfi, ccnt, cwt)
        have = have | v
        ccnt = jnp.where(newg, cnt, jnp.where(same, ccnt + cnt, ccnt))
        cwt = jnp.where(newg, wt, jnp.where(same, cwt + wt, cwt))
        cfi = jnp.where(newg, fi, cfi)
        return (have, cfi, ccnt, cwt), y

    init = (valid[:, 0] & False, zero, zero, zf)
    (have, cfi, ccnt, cwt), ys = jax.lax.scan(
        coll_step, init, (valid.T, p_fi.T, p_cnt.T, p_wt.T))
    coll_emit = jnp.concatenate([ys[0].T, have[:, None]], axis=1)
    coll_fi = jnp.concatenate([ys[1].T, cfi[:, None]], axis=1)
    coll_cnt = jnp.concatenate([ys[2].T, ccnt[:, None]], axis=1)
    coll_wt = jnp.concatenate([ys[3].T, cwt[:, None]], axis=1)
    n2, (q_fi, q_cnt, q_wt) = _left_pack(coll_emit,
                                         [coll_fi, coll_cnt, coll_wt])
    M2 = q_fi.shape[1]
    valid2 = jax.lax.broadcasted_iota(jnp.int32, (B, M2), 1) < n2[:, None]

    # --- bridge-merge (kguts.cc:1063-1086): state (cur, held interior)
    def bridge_step(s, x):
        have_c, fi_c, cnt_c, wt_c, have_h, fi_h, cnt_h, wt_h = s
        v, fi, cnt, wt = x
        # case A: no cur yet
        a = v & ~have_c
        # case B: cur, no held
        b = v & have_c & ~have_h
        # case C: cur + held; incoming plays comp2
        c = v & have_c & have_h
        mrg = c & (fi == fi_c) & (cnt_h < 5) & (cnt_c + cnt >= 10)
        emit_cur = c & ~mrg
        y = (emit_cur, fi_c, cnt_c, wt_c)
        # merged: cur absorbs incoming; held discarded
        n_have_c = have_c | a
        n_fi_c = jnp.where(a, fi, jnp.where(emit_cur, fi_h, fi_c))
        n_cnt_c = jnp.where(a, cnt, jnp.where(
            mrg, cnt_c + cnt, jnp.where(emit_cur, cnt_h, cnt_c)))
        n_wt_c = jnp.where(a, wt, jnp.where(
            mrg, wt_c + wt, jnp.where(emit_cur, wt_h, wt_c)))
        n_have_h = jnp.where(mrg, False, jnp.where(emit_cur | b, True, have_h))
        n_fi_h = jnp.where(b | emit_cur, fi, fi_h)
        n_cnt_h = jnp.where(b | emit_cur, cnt, cnt_h)
        n_wt_h = jnp.where(b | emit_cur, wt, wt_h)
        return (n_have_c, n_fi_c, n_cnt_c, n_wt_c,
                n_have_h, n_fi_h, n_cnt_h, n_wt_h), y

    initb = (valid2[:, 0] & False, zero, zero, zf,
             valid2[:, 0] & False, zero, zero, zf)
    sb, ysb = jax.lax.scan(bridge_step, initb,
                           (valid2.T, q_fi.T, q_cnt.T, q_wt.T))
    have_c, fi_c, cnt_c, wt_c, have_h, fi_h, cnt_h, wt_h = sb
    br_emit = jnp.concatenate(
        [ysb[0].T, have_c[:, None], have_h[:, None]], axis=1)
    br_fi = jnp.concatenate([ysb[1].T, fi_c[:, None], fi_h[:, None]], axis=1)
    br_cnt = jnp.concatenate([ysb[2].T, cnt_c[:, None], cnt_h[:, None]],
                             axis=1)
    br_wt = jnp.concatenate([ysb[3].T, wt_c[:, None], wt_h[:, None]], axis=1)

    # --- per-function totals in ascending fI, f32 adds in merged order:
    # stable sort by fI (invalid -> BIG), then run-boundary accumulation
    BIG = jnp.int32(2 ** 30)
    key = jnp.where(br_emit, br_fi, BIG)
    s_fi, s_cnt, s_wt = jax.lax.sort(
        (key, br_cnt, br_wt), dimension=1, num_keys=1, is_stable=True)
    M3 = s_fi.shape[1]

    def tot_step(s, x):
        have, tfi, tcnt, twt = s
        fi, cnt, wt = x
        v = fi < BIG
        same = v & have & (fi == tfi)
        newg = v & (~have | (fi != tfi))
        y_emit = newg & have
        y = (y_emit, tfi, tcnt, twt)
        have = have | v
        tcnt = jnp.where(newg, cnt, jnp.where(same, tcnt + cnt, tcnt))
        twt = jnp.where(newg, wt, jnp.where(same, twt + wt, twt))
        tfi = jnp.where(newg, fi, tfi)
        return (have, tfi, tcnt, twt), y

    initt = (zero != 0, zero, zero, zf)
    (have, tfi, tcnt, twt), yst = jax.lax.scan(
        tot_step, initt, (s_fi.T, s_cnt.T, s_wt.T))
    tot_emit = jnp.concatenate([yst[0].T, have[:, None]], axis=1)
    tot_fi = jnp.concatenate([yst[1].T, tfi[:, None]], axis=1)
    tot_cnt = jnp.concatenate([yst[2].T, tcnt[:, None]], axis=1)
    tot_wt = jnp.concatenate([yst[3].T, twt[:, None]], axis=1)

    # --- literal libstdc++ heap-select over the totals stream
    # comp(a, b) := a.wt > b.wt; j counts entries seen so far.
    def heap_step(s, x):
        (j, h0f, h0c, h0w, h1f, h1c, h1w, v2c) = s
        v, fi, cnt, wt = x
        is0 = v & (j == 0)
        is1 = v & (j == 1)
        is2 = v & (j == 2)
        # j == 0: stash e0 in h0
        h0f0 = jnp.where(is0, fi, h0f)
        h0c0 = jnp.where(is0, cnt, h0c)
        h0w0 = jnp.where(is0, wt, h0w)
        # j == 1: make_heap([e0, e1]): value=e0; slot0=e1;
        # if comp(slot0, value): slot1=slot0; slot0=value else slot1=value
        c1 = wt > h0w0  # comp(e1, e0)
        mh0f = jnp.where(is1, jnp.where(c1, h0f0, fi), h0f0)
        mh0c = jnp.where(is1, jnp.where(c1, h0c0, cnt), h0c0)
        mh0w = jnp.where(is1, jnp.where(c1, h0w0, wt), h0w0)
        mh1f = jnp.where(is1, jnp.where(c1, fi, h0f0), h1f)
        mh1c = jnp.where(is1, jnp.where(c1, cnt, h0c0), h1c)
        mh1w = jnp.where(is1, jnp.where(c1, wt, h0w0), h1w)
        # j >= 2: if comp(e, h0): pop_push — vec[j] = old h0; then
        # value=e: slot0=slot1; if comp(slot0, value): slot1=slot0,
        # slot0=value else slot1=value
        ge2 = v & (j >= 2)
        cin = ge2 & (wt > mh0w)
        # vec[2] records at j == 2: displaced value = old h0 if swapped
        # else the entry itself
        v2c = jnp.where(is2, jnp.where(wt > mh0w, mh0c, cnt), v2c)
        # pop_push: slot0 <- old slot1; if comp(slot0, value):
        # slot1 <- slot0, slot0 <- value else slot1 <- value
        c2 = mh1w > wt  # comp(old h1, value)
        fh0f = jnp.where(cin, jnp.where(c2, fi, mh1f), mh0f)
        fh0c = jnp.where(cin, jnp.where(c2, cnt, mh1c), mh0c)
        fh0w = jnp.where(cin, jnp.where(c2, wt, mh1w), mh0w)
        fh1f = jnp.where(cin, jnp.where(c2, mh1f, fi), mh1f)
        fh1c = jnp.where(cin, jnp.where(c2, mh1c, cnt), mh1c)
        fh1w = jnp.where(cin, jnp.where(c2, mh1w, wt), mh1w)
        j = j + v.astype(jnp.int32)
        return (j, fh0f, fh0c, fh0w, fh1f, fh1c, fh1w, v2c), None

    inith = (zero, zero, zero, zf, zero, zero, zf, zero)
    sh, _ = jax.lax.scan(heap_step, inith,
                         (tot_emit.T, tot_fi.T, tot_cnt.T, tot_wt.T))
    n_funcs, h0f, h0c, h0w, h1f, h1c, h1w, v2c = sh
    # sort_heap swap: vec0 = slot1, vec1 = slot0 (when n >= 2);
    # n == 1: vec0 = the single stashed entry (slot0)
    one = n_funcs == 1
    fi0 = jnp.where(one, h0f, h1f)
    cnt0 = jnp.where(one, h0c, h1c)
    wt0 = jnp.where(one, h0w, h1w)
    fi1, cnt1, wt1 = h0f, h0c, h0w
    return (n_funcs, fi0, cnt0, wt0, fi1, cnt1, wt1, v2c, overflow)


@functools.partial(
    jax.jit,
    static_argnames=("min_hits", "min_weighted_hits", "max_gap",
                     "order_constraint", "wide_w", "sub_w", "fused_w"))
def _probe_best_jit(bucket_pair, lo_arr, payload,
                    n, n_steps, offsets, lengths,
                    min_hits, min_weighted_hits, max_gap, order_constraint,
                    lo_wide=None, payload_wide=None, wide_w=0,
                    sub_header=None, sub_blocks=None, sub_w=0,
                    fused_wide=None, fused_w=0):
    """Fused probe + scan scoring + device find_best_call reductions.
    Output: one packed int32 buffer [B, 9] (wt fields bitcast; col 8 =
    overflow flag -> row needs the host fallback path)."""
    ddb = DeviceDB(bucket_pair, lo_arr, payload, n_steps, n, lo_wide,
                   payload_wide, wide_w, sub_header, sub_blocks, sub_w,
                   fused_wide, fused_w)
    hi, lo, valid = encode_windows(offsets, lengths)
    found, p_fi, p_oi, p_av, p_wt, _ = probe_windows(ddb, hi, lo, valid)
    emit, (c_start, c_end, c_cnt, c_fi, c_wt) = _scan_score(
        found, p_fi, p_av, p_wt, min_hits, min_weighted_hits, max_gap,
        order_constraint)
    (n_funcs, fi0, cnt0, wt0, fi1, cnt1, wt1, v2c, ovf) = _best_call_device(
        emit, c_cnt, c_fi, c_wt)
    bc = jax.lax.bitcast_convert_type
    out = jnp.stack([n_funcs, fi0, cnt0, bc(wt0, jnp.int32),
                     fi1, cnt1, bc(wt1, jnp.int32), v2c,
                     ovf.astype(jnp.int32)], axis=1)
    return out


@functools.partial(
    jax.jit,
    static_argnames=("min_hits", "min_weighted_hits", "max_gap",
                     "order_constraint", "call_cap", "L",
                     "pack_mode", "wide_w", "sub_w", "fused_w", "slim"))
def _probe_score_jit(bucket_pair, lo_arr, payload,
                     n, n_steps, offsets, lengths,
                     min_hits, min_weighted_hits, max_gap, order_constraint,
                     call_cap, L=0, lo_wide=None,
                     pack_mode=1, payload_wide=None, wide_w=0,
                     sub_header=None, sub_blocks=None, sub_w=0,
                     fused_wide=None, fused_w=0, slim=0):
    ddb = DeviceDB(bucket_pair, lo_arr, payload, n_steps, n, lo_wide,
                   payload_wide, wide_w, sub_header, sub_blocks, sub_w,
                   fused_wide, fused_w)
    if L:  # offsets arrive 5-bit packed; L = unpacked padded width
        if pack_mode == 2:   # planar i32 words (engine.pack_offsets_planar)
            from .engine import unpack_offsets_planar
            offsets = unpack_offsets_planar(offsets, L)
        else:                # byte-interleaved u8 (engine.pack_offsets)
            from .engine import unpack_offsets
            offsets = unpack_offsets(offsets, L)
    hi, lo, valid = encode_windows(offsets, lengths)
    found, p_fi, p_oi, p_av, p_wt, _ = probe_windows(ddb, hi, lo, valid)
    emit, (c_start, c_end, c_cnt, c_fi, c_wt) = _scan_score(
        found, p_fi, p_av, p_wt, min_hits, min_weighted_hits, max_gap,
        order_constraint)

    B, W1 = emit.shape
    n_calls = emit.sum(axis=1, dtype=jnp.int32)

    # Compact: stable argsort on ~emit keeps row-major (= per-sequence,
    # position-ordered) order among the emitted calls.
    flat_emit = emit.reshape(-1)
    order = jnp.argsort(~flat_emit, stable=True)[:call_cap]
    if slim == 2:
        # folded 2-plane pack (cnt << CALL_FOLD_SHIFT | fi, wt): the
        # best-call serving mode never reads call positions
        # (kguts.cc:1023-1139) and the fold is legal when fi fits
        # CALL_FOLD_SHIFT bits — callers gate via DeviceScorer.slim_mode
        from .device_family import CALL_FOLD_SHIFT
        planes = [
            (c_cnt.reshape(-1)[order].astype(jnp.int32) << CALL_FOLD_SHIFT)
            | c_fi.reshape(-1)[order].astype(jnp.int32),
            jax.lax.bitcast_convert_type(c_wt.reshape(-1)[order],
                                         jnp.int32),
        ]
    elif slim == 3:
        planes = [
            c_cnt.reshape(-1)[order].astype(jnp.int32),
            c_fi.reshape(-1)[order].astype(jnp.int32),
            jax.lax.bitcast_convert_type(c_wt.reshape(-1)[order],
                                         jnp.int32),
        ]
    else:
        planes = [
            c_start.reshape(-1)[order].astype(jnp.int32),
            c_end.reshape(-1)[order].astype(jnp.int32),
            c_cnt.reshape(-1)[order].astype(jnp.int32),
            c_fi.reshape(-1)[order].astype(jnp.int32),
            jax.lax.bitcast_convert_type(c_wt.reshape(-1)[order],
                                         jnp.int32),
        ]
    pack = jnp.stack(planes)
    # single packed buffer: [B] n_calls ++ [n_planes*call_cap] fields
    out = jnp.concatenate([n_calls, pack.reshape(-1)])
    n_hits_total = found.sum(dtype=jnp.int32)
    return out, n_hits_total


class DeviceScorer:
    """Fused probe+score engine: uploads a padded batch, downloads only the
    packed compact call lists."""

    def __init__(self, db, device=None, ddb=None):
        """``ddb``: score against an existing DeviceDB (any layout)
        instead of building one from ``db``."""
        self.db = db
        self.ddb = ddb if ddb is not None else DeviceDB.from_db(
            db, device=device)

    def score_batch(self, offsets: np.ndarray, lengths: np.ndarray,
                    params: EngineParams | None = None,
                    calls_per_seq_cap: int = 4):
        """Returns (n_calls[B], calls) where calls is a list of per-seq
        lists of (start, end, count, fi, weighted_f32).  If the emitted
        call count exceeds the cap, the overflowing tail is absent —
        callers should retry with a bigger cap (n_calls reports the true
        totals)."""
        params = params or EngineParams()
        d = self.ddb
        B = offsets.shape[0]
        cap = B * calls_per_seq_cap
        out, _ = _probe_score_jit(
            d.bucket_pair, d.lo, d.payload, d.n,
            d.n_steps, jnp.asarray(offsets), jnp.asarray(lengths),
            params.min_hits, params.min_weighted_hits, params.max_gap,
            params.order_constraint, cap, 0, d.lo_wide,
            1, d.payload_wide, d.wide_w, d.sub_header, d.sub_blocks,
            d.sub_w, d.fused_wide, d.fused_w)
        out = np.asarray(out)
        n_calls = out[:B]
        pack = out[B:].reshape(5, cap)
        starts, ends, cnts, fis = pack[0], pack[1], pack[2], pack[3]
        wts = pack[4].view(np.float32)
        total = int(n_calls.sum())
        if total > cap:
            return self.score_batch(offsets, lengths, params,
                                    calls_per_seq_cap * 4)
        calls = []
        k = 0
        for b in range(B):
            calls.append([(int(starts[k + i]), int(ends[k + i]),
                           int(cnts[k + i]), int(fis[k + i]),
                           np.float32(wts[k + i]))
                          for i in range(int(n_calls[b]))])
            k += int(n_calls[b])
        return n_calls, calls

    @staticmethod
    def unpack_dense(out: np.ndarray, B: int, cap: int):
        """Packed device buffer -> (n_calls[B], dense [B, maxc] call arrays
        (start, end, count, fi, wt)) for native best-call reduction.
        Returns None if the cap overflowed (caller retries bigger)."""
        n_calls = out[:B]
        total = int(n_calls.sum())
        # The device pack holds min(cap, theoretical max) entries (the
        # argsort slice clamps), so size from the buffer, not `cap`: an
        # over-escalated cap must degrade gracefully, not ValueError.
        pack = out[B:].reshape(5, -1)
        if total > pack.shape[1]:
            return None
        maxc = max(1, int(n_calls.max()) if B else 1)
        rows = np.repeat(np.arange(B), n_calls)
        row_off = np.zeros(B + 1, dtype=np.int64)
        np.cumsum(n_calls, out=row_off[1:])
        cols = np.arange(total) - row_off[rows]
        dense = []
        for j in range(5):
            d = np.zeros((B, maxc), dtype=np.int32)
            d[rows, cols] = pack[j, :total]
            dense.append(d)
        cs, ce, cc, cf, cw_bits = dense
        return n_calls, cs, ce, cc, cf, cw_bits.view(np.float32)

    @staticmethod
    def unpack_dense3(out: np.ndarray, B: int, cap: int):
        """Slim-pack variant (3 planes: count, fi, wt-bits — the
        best-match path's calls, device_family._score_family_jit
        slim_calls=True).  Returns (n_calls, cc, cf, cw) or None on cap
        overflow; start/end are not present (the best-call reduction
        never reads them)."""
        n_calls = out[:B]
        total = int(n_calls.sum())
        pack = out[B:].reshape(3, -1)
        if total > pack.shape[1]:
            return None
        maxc = max(1, int(n_calls.max()) if B else 1)
        rows = np.repeat(np.arange(B), n_calls)
        row_off = np.zeros(B + 1, dtype=np.int64)
        np.cumsum(n_calls, out=row_off[1:])
        cols = np.arange(total) - row_off[rows]
        dense = []
        for j in range(3):
            d = np.zeros((B, maxc), dtype=np.int32)
            d[rows, cols] = pack[j, :total]
            dense.append(d)
        cc, cf, cw_bits = dense
        return n_calls, cc, cf, cw_bits.view(np.float32)

    @staticmethod
    def unpack_dense2(out: np.ndarray, B: int, cap: int):
        """Folded slim-pack variant (2 planes: cnt<<18|fi, wt-bits —
        device_family._score_family_jit with fold_calls; see
        DeviceFamilyScorer.pack_flags).  Returns (n_calls, cc, cf, cw)
        or None on cap overflow."""
        n_calls = out[:B]
        total = int(n_calls.sum())
        pack = out[B:].reshape(2, -1)
        if total > pack.shape[1]:
            return None
        maxc = max(1, int(n_calls.max()) if B else 1)
        rows = np.repeat(np.arange(B), n_calls)
        row_off = np.zeros(B + 1, dtype=np.int64)
        np.cumsum(n_calls, out=row_off[1:])
        cols = np.arange(total) - row_off[rows]
        dense = []
        for j in range(2):
            d = np.zeros((B, maxc), dtype=np.int32)
            d[rows, cols] = pack[j, :total]
            dense.append(d)
        from .device_family import CALL_FOLD_SHIFT
        cnt_fi, cw_bits = dense
        return (n_calls, cnt_fi >> CALL_FOLD_SHIFT,
                cnt_fi & ((1 << CALL_FOLD_SHIFT) - 1),
                cw_bits.view(np.float32))

    def best_batch_packed(self, offsets, lengths,
                          params: EngineParams | None = None):
        """Fully-fused best-call path: probe + scan + device
        find_best_call reductions.  Returns the un-transferred [B, 8]
        int32 device buffer (pipeline-friendly): columns are
        n_funcs, fi0, cnt0, wt0(bits), fi1, cnt1, wt1(bits), vec2_cnt."""
        params = params or EngineParams()
        d = self.ddb
        return _probe_best_jit(
            d.bucket_pair, d.lo, d.payload, d.n,
            d.n_steps, jnp.asarray(offsets), jnp.asarray(lengths),
            params.min_hits, params.min_weighted_hits, params.max_gap,
            params.order_constraint, d.lo_wide, d.payload_wide, d.wide_w,
            d.sub_header, d.sub_blocks, d.sub_w,
            d.fused_wide, d.fused_w)

    def best_calls_batch(self, offsets, lengths, function_of,
                         params: EngineParams | None = None):
        """Complete fused best-call path: device reductions + host
        decision, with rows that overflow the device call-stream cap
        (>32 calls, col 8 flag) re-scored exactly through the
        compact-call path + the native top-3 reduction."""
        from ..native import api as native
        from .engine import finish_best_call
        params = params or EngineParams()
        out = np.asarray(self.best_batch_packed(offsets, lengths, params))
        ovf = out[:, 8] != 0 if out.shape[1] > 8 \
            else np.zeros(len(out), bool)
        res = self.finish_best_batch(out, function_of, overflow="ignore")
        if ovf.any():
            rows = np.nonzero(ovf)[0]
            sub_off = np.ascontiguousarray(offsets[rows])
            sub_len = np.ascontiguousarray(lengths[rows])
            dev, cap = self.score_batch_packed(
                sub_off, sub_len, params,
                calls_per_seq_cap=float(sub_off.shape[1]))
            dense = self.unpack_dense(np.asarray(dev), len(rows), cap)
            n_calls, cs, ce, cc, cf, cw = dense
            nf, ofi, ocnt, owt = native.best_call_batch(
                n_calls, cs, ce, cc, cf, cw)
            for k, r in enumerate(rows):
                res[r] = finish_best_call(int(nf[k]), ofi[k], ocnt[k],
                                          owt[k], function_of)
        return res

    @staticmethod
    def finish_best_batch(out_np: np.ndarray, function_of,
                          overflow: str = "raise"):
        """Host decision step over the device reductions; returns
        oracle.BestCall per row (exact, including the lexicographic
        ambiguous-pair naming).  ``overflow="ignore"`` skips the cap
        check (callers like best_calls_batch re-score flagged rows)."""
        from .engine import finish_best_call
        if (overflow == "raise" and out_np.shape[1] > 8
                and out_np[:, 8].any()):
            raise OverflowError(
                "rows exceeded the device call-stream cap; use the "
                "score_batch path for these sequences")
        res = []
        wt_bits = out_np[:, [3, 6]].copy().view(np.float32)
        for r in range(out_np.shape[0]):
            nf = int(out_np[r, 0])
            fi3 = (int(out_np[r, 1]), int(out_np[r, 4]), 0)
            cnt3 = (int(out_np[r, 2]), int(out_np[r, 5]), int(out_np[r, 7]))
            wt3 = (np.float32(wt_bits[r, 0]), np.float32(wt_bits[r, 1]),
                   np.float32(0.0))
            res.append(finish_best_call(nf, fi3, cnt3, wt3, function_of))
        return res

    def slim_mode(self) -> int:
        """The cheapest legal call-pack for best-call-only consumers:
        2 (folded cnt|fi plane) when every fi fits CALL_FOLD_SHIFT bits,
        else 3 (separate cnt/fi planes).  Positions are dropped either
        way — find_best_call never reads them (kguts.cc:1023-1139)."""
        from .device_family import CALL_FOLD_SHIFT
        n_funcs = int(self.db.fi.max()) + 1 if len(self.db) else 1
        return 2 if n_funcs < (1 << CALL_FOLD_SHIFT) else 3

    def score_batch_packed(self, offsets, lengths,
                           params: EngineParams | None = None,
                           calls_per_seq_cap: float = 4,
                           packed_L: int = 0, pack_mode: int = 1,
                           slim: int = 0):
        """Async-friendly variant: returns the device array (not yet
        transferred) so callers can pipeline dispatch and readback.
        If ``packed_L`` is nonzero, ``offsets`` arrives 5-bit packed and
        unpacks to [B, packed_L] on device: pack_mode 1 = byte-interleaved
        u8 (engine.pack_offsets), 2 = planar i32 words
        (engine.pack_offsets_planar).
        ``slim`` (0/2/3, see :meth:`slim_mode`) selects the call-pack
        plane count; unpack with unpack_dense / unpack_dense2 /
        unpack_dense3 accordingly."""
        params = params or EngineParams()
        d = self.ddb
        # fractional caps allowed: the cap bounds TOTAL calls per batch
        cap = int(offsets.shape[0] * calls_per_seq_cap)
        out, _ = _probe_score_jit(
            d.bucket_pair, d.lo, d.payload, d.n,
            d.n_steps, jnp.asarray(offsets), jnp.asarray(lengths),
            params.min_hits, params.min_weighted_hits, params.max_gap,
            params.order_constraint, cap, packed_L,
            d.lo_wide, pack_mode, d.payload_wide, d.wide_w,
            d.sub_header, d.sub_blocks, d.sub_w,
            d.fused_wide, d.fused_w, slim)
        return out, cap
