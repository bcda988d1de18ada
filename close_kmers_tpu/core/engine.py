"""Batch engine: encode → probe → score.

The reference engine scans one sequence at a time on one CPU thread,
chasing linear-probe chains through a giant mmap
(reference kguts.cc:783-877, 585-602).  The batched replacement
processes a padded batch ``[B, L]`` of amino-acid offsets in three stages:

1. **window encode** — every window start position gets an int32
   ``(hi, lo)`` code pair via strided adds (no 64-bit math, no rolling
   dependence: position i's code depends only on ``aa[i:i+8]``);
2. **probe** — a branchless batched binary search against the two-level
   sorted signature index (:class:`close_kmers_tpu.db.signature_db.SignatureDB`):
   gather the ``bucket_start`` bounds for ``hi``, then a fixed-step
   lower-bound search over the bucket's ``lo`` values, then payload
   gathers.  Replaces lookup_hash_entry's memory-latency-bound chain walk
   with bandwidth-friendly vectorized gathers;
3. **score** — the sequential run/gap/two-hit state machine
   (kguts.cc:734-877).  Stage 3 consumes only the tiny per-sequence hit
   lists (typically 1-3 orders of magnitude smaller than the position
   stream), so v0 replays it on the host through the same
   :class:`close_kmers_tpu.core.oracle.GatherState` the oracle uses —
   bit-identical by construction.  A native C++ replayer and an on-device
   scan are drop-in replacements behind the same hit-list interface.

Exactness: stages 1+2 are exact (integer compares); they are tested
position-for-position against the oracle's scalar loop.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import os

import jax
import jax.numpy as jnp
import numpy as np

from ..params import K, LO_CARD, EngineParams
from ..ops.encoder import seq_to_offsets
from ..db.signature_db import SignatureDB
from . import oracle as O


def _probe_count_pad(n: int) -> int:
    """Flattened probe-count padding: pad the flat index vector to the
    next length ≡ 8 (mod 16), capping the 2-adic valuation at 3; the <=
    15 extra probes are masked out after selection.  Added for a
    row-gather slowdown at power-of-two-rich index counts (B*W with B a
    power of two) on the first target; whether the card needs it is
    open (ROADMAP queue 1 #6)."""
    return n + (8 - n % 16) % 16


def _lane_pad(w: int) -> int:
    """Row width for the wide gatherable layouts: the next multiple of
    128 when the waste stays under ~1/3, else the exact width (aligned
    rows gathered faster on the first target; not yet re-measured on the
    card).  The tables span all HI_CARD rows, so padding tiny-bucket DBs
    (tests, CPU backends) would inflate them ~10x for no benefit."""
    aligned = -(-w // 128) * 128
    return aligned if aligned * 3 <= w * 4 else w


@dataclasses.dataclass
class DeviceDB:
    """Signature DB resident on device (single-chip form).

    Layout tuned for gather-op count (on the first target a gather op
    cost about the same whatever its row width): bucket bounds
    live as [HI_CARD, 2] rows (one gather instead of two), the payload is
    interleaved as [N+1, 4] int32 rows (fi, oi, avg_off, wt-bits — one
    gather instead of four), and HI_DIGITS=5 keeps buckets tiny so the
    in-bucket lower-bound search needs only ~n_steps=5 lo gathers.
    """

    bucket_pair: jax.Array   # i32[HI_CARD, 2] = (start, end)
    lo: jax.Array            # i32[N+1]
    payload: jax.Array       # i32[N+1, 4] = fi, oi, avg_off, wt-bits
    n_steps: int
    n: int
    # Optional wide-bucket layout: when every bucket fits WIDE_BUCKET_MAX
    # entries, the bucket's start row index AND its lo values live in one
    # gatherable [1+W] row (col 0 = start, cols 1.. = sentinel-padded lo),
    # so the probe is 2 gather ops total (fused row, payload) — the
    # bucket_pair gather is skipped entirely.  None disables (falls back
    # to the bounds + binary-search loop).
    lo_wide: jax.Array | None = None
    # Optional single-gather layout: the payload planes (fi, oi, avg_off,
    # wt-bits) are stored alongside the lo plane in the same row —
    # [1 + 5W] per bucket — so ONE gather yields the match test AND the
    # matched payload (selected with in-register masked sums).  Costs
    # HI_CARD*(1+5W)*4 bytes, so it is gated by WIDE_PAYLOAD_SHARE of the
    # device's memory; when None the 2-gather layout applies.
    payload_wide: jax.Array | None = None
    # True per-bucket width W of payload_wide's planes.  The array's rows
    # are zero-padded up to a multiple of 128 int32 (_lane_pad), so W is
    # no longer derivable from the row shape; 0 means "unpadded, derive
    # from shape" (the sharded path's layout).
    wide_w: int = 0
    # Optional deep-bucket layout (PATRIC-density DBs, avg bucket >>
    # WIDE_BUCKET_MAX, where wide rows would be KB-scale and the binary
    # search needs ~10 dependent gathers): each bucket splits into
    # SUB=16 sub-buckets by the lo code's top bits; sub_header[h] holds
    # the 16 block-row ids and sub_blocks[b] a payload-wide-format row
    # [global_start, lo plane, fi, oi, avg_off, wt-bits] padded to the
    # max sub-bucket depth.  Probe = header gather + in-register one-hot
    # select + block gather — 2 gather ops regardless of bucket depth.
    sub_header: jax.Array | None = None   # i32[HI_CARD, SUB]
    sub_blocks: jax.Array | None = None   # i32[n_nonempty+1, 1+5*max_sub]
    # true per-block width (rows lane-padded like payload_wide; 0 =
    # unpadded, derive from shape)
    sub_w: int = 0
    # Fused packed scale layout: rows [start | (fi<<13 | lo) x W |
    # wt-bits x W | sentinel pad].  fi and wt come out of the SAME
    # gather, so the [N+1, 4] payload gather exists only for oi/avg_off
    # consumers (XLA DCEs it per-jit when those planes are unused — the
    # family, fq and best-call paths).  Requires n_functions < 2^18
    # (lo < 8000 fits 13 bits).  Preferred over lo_wide at the scale
    # tier: one gather instead of two on the hot paths.
    fused_wide: jax.Array | None = None   # i32[HI_CARD, lane_pad(1+2W)]
    fused_w: int = 0

    FUSED_LO_BITS = 13
    FUSED_SENTINEL = (1 << 30) | 0x1FFF   # low 13 bits never match a lo

    WIDE_BUCKET_MAX = 32  # memory/time tradeoff bound (HI_CARD*W*4 bytes)
    # Byte gates of the layouts, as shares of the device's memory
    # (device_memory_bytes): a layout is built only while its table fits
    # its share.
    WIDE_PAYLOAD_SHARE = 1 / 8
    FUSED_SHARE = 1 / 4
    # fused rows carry 2W+1 ints: beyond ~128-deep buckets the row tops
    # 1 KB and the gather goes byte-bound, while the sub tier's cost does
    # not grow with depth — the auto ladder hands deep DBs to sub
    FUSED_BUCKET_MAX = 128
    SUB = 16              # sub-buckets per bucket (power of two)
    SUB_BUCKET_MAX = 256  # max entries per sub-bucket (block row width)
    SUB_SHARE = 1 / 4
    # lo_wide fallback budget: at PATRIC density (e.g. 208M keys, avg
    # bucket ~65, max ~110) payload_wide and sub blocks outgrow their
    # shares, but the lo-only wide table is H * lane_pad(1+max_bucket)
    # * 4 B (~1.6 GB) and needs one gather where the binary search needs
    # one per halving step.
    LO_WIDE_SHARE = 3 / 16

    @classmethod
    def from_db(cls, db: SignatureDB, device=None,
                wide: bool | None = None,
                wide_payload: bool | None = None,
                sub: bool | None = None,
                wide_lo: bool | None = None,
                fused: bool | None = None) -> "DeviceDB":
        put = functools.partial(jax.device_put, device=device)
        mem = device_memory_bytes(device)
        n_steps = max(1, math.ceil(math.log2(db.max_bucket + 1))) if len(db) else 1
        n = len(db)
        pair = np.stack([db.bucket_start[:-1], db.bucket_start[1:]],
                        axis=1).astype(np.int32)
        lo = np.concatenate([db.lo, np.array([-1], np.int32)])
        payload = np.zeros((n + 1, 4), dtype=np.int32)
        payload[:n, 0] = db.fi
        payload[:n, 1] = db.oi
        payload[:n, 2] = db.avg_off
        payload[:n, 3] = db.wt.view(np.int32)
        payload[n] = (-1, -1, 0, 0)
        if wide is None:
            wide = 0 < db.max_bucket <= cls.WIDE_BUCKET_MAX
        H = len(pair)
        WIDE = max(1, int(db.max_bucket))
        if wide_payload is None:
            wide_payload = (wide and
                            H * (1 + 5 * WIDE) * 4
                            <= cls.WIDE_PAYLOAD_SHARE * mem)
        lo_wide = None
        payload_wide = None
        starts = db.bucket_start[:-1]
        counts = db.bucket_start[1:] - starts
        wide_w = 0
        if wide and wide_payload and n:
            row_w = _lane_pad(1 + 5 * WIDE)
            pw = np.zeros((H, row_w), dtype=np.int32)
            pw[:, 0] = starts
            pw[:, 1:1 + WIDE] = 2 ** 30  # lo plane sentinel: never matches
            planes = (db.lo, db.fi, db.oi, db.avg_off, db.wt.view(np.int32))
            for j in range(WIDE):
                m = counts > j
                rows = starts[m] + j
                for p, plane in enumerate(planes):
                    pw[m, 1 + p * WIDE + j] = plane[rows]
            payload_wide = put(jnp.asarray(pw))
            wide_w = WIDE

        fused_wide = None
        fused_w = 0
        fi_max = int(db.fi.max()) if n else 0
        if fused is None:
            fused = (fi_max < (1 << (31 - cls.FUSED_LO_BITS))
                     and 0 < db.max_bucket <= cls.FUSED_BUCKET_MAX
                     and H * _lane_pad(1 + 2 * WIDE) * 4
                     <= cls.FUSED_SHARE * mem)
        if payload_wide is None and n and fused:
            # fused packed rows (see the dataclass comment): one flat
            # scatter builds both planes.
            row_w = _lane_pad(1 + 2 * WIDE)
            fw = np.full(H * row_w, cls.FUSED_SENTINEL, dtype=np.int32)
            fw[::row_w][:H] = starts
            rank = np.arange(n, dtype=np.int64) \
                - db.bucket_start[db.hi].astype(np.int64)
            rows_f = db.hi.astype(np.int64) * row_w
            fw[rows_f + 1 + rank] = \
                (db.fi.astype(np.int64) << cls.FUSED_LO_BITS) | db.lo
            fw[rows_f + 1 + WIDE + rank] = db.wt.view(np.int32)
            fused_wide = put(jnp.asarray(fw.reshape(H, row_w)))
            fused_w = WIDE
            del fw

        sub_header = sub_blocks = None
        sub_w = 0
        if sub is None:
            sub = not wide and n > 0
        if sub and not wide and n and fused_wide is None:
            from ..params import LO_CARD
            shift = (LO_CARD - 1).bit_length() - (cls.SUB.bit_length() - 1)
            skey = db.hi.astype(np.int64) * cls.SUB + (db.lo >> shift)
            ukeys, ustart, ucnt = np.unique(
                skey, return_index=True, return_counts=True)
            max_sub = int(ucnt.max())
            nb = len(ukeys)
            if (max_sub <= cls.SUB_BUCKET_MAX
                    and (nb + 1) * (1 + 5 * max_sub) * 4
                    <= cls.SUB_SHARE * mem):
                row_w = _lane_pad(1 + 5 * max_sub)
                blocks = np.zeros((nb + 1, row_w), dtype=np.int32)
                blocks[:, 1:1 + max_sub] = 2 ** 30  # lo sentinel
                blocks[:nb, 0] = ustart
                blocks[nb, 0] = n                   # miss row -> idx = n
                planes = (db.lo, db.fi, db.oi, db.avg_off,
                          db.wt.view(np.int32))
                for j in range(max_sub):
                    m = ucnt > j
                    rows = ustart[m] + j
                    for p, plane in enumerate(planes):
                        blocks[:nb][m, 1 + p * max_sub + j] = plane[rows]
                header = np.full((H, cls.SUB), nb, dtype=np.int32)
                header[ukeys // cls.SUB, ukeys % cls.SUB] = \
                    np.arange(nb, dtype=np.int32)
                sub_header = put(jnp.asarray(header))
                sub_blocks = put(jnp.asarray(blocks))
                sub_w = max_sub

        if wide_lo is None:
            wide_lo = (wide or
                       H * _lane_pad(1 + WIDE) * 4 <= cls.LO_WIDE_SHARE * mem)
        if (payload_wide is None and sub_blocks is None and n and wide_lo
                and fused_wide is None):
            # lo-only wide rows [start, sentinel-padded lo plane]: the
            # small-DB wide tier when payload_wide is byte-gated, and the
            # scale tier when sub blocks are byte-gated.  Built with one
            # flat scatter (per-key rank within its bucket).
            row_w = _lane_pad(1 + WIDE)
            lw = np.full(H * row_w, 2 ** 30, dtype=np.int32)
            lw[::row_w][:H] = starts
            rank = np.arange(n, dtype=np.int64) \
                - db.bucket_start[db.hi].astype(np.int64)
            lw[db.hi.astype(np.int64) * row_w + 1 + rank] = db.lo
            lo_wide = put(jnp.asarray(lw.reshape(H, row_w)))
            del lw

        # Slim uploads: the binary-search arrays are dead when a wide/sub
        # layout probes instead, and the [N+1, 4] payload is dead when the
        # layout carries its own payload planes — at 208M keys that skips
        # ~4.2 GB of HBM + transfer.  Dummies keep the jit signatures and
        # the miss-row convention (idx = n) intact.
        has_layout = (payload_wide is not None or sub_blocks is not None
                      or lo_wide is not None or fused_wide is not None)
        if has_layout:
            pair = pair[:0]
            lo = lo[:1]
        if payload_wide is not None or sub_blocks is not None:
            payload = payload[-1:]
        return cls(
            bucket_pair=put(jnp.asarray(pair)),
            lo=put(jnp.asarray(lo)),
            payload=put(jnp.asarray(payload)),
            n_steps=n_steps,
            n=n,
            fused_wide=fused_wide,
            fused_w=fused_w,
            lo_wide=lo_wide,
            payload_wide=payload_wide,
            wide_w=wide_w,
            sub_header=sub_header,
            sub_blocks=sub_blocks,
            sub_w=sub_w,
        )


# Banded-matmul encode band size cap: the [L, 2W] f32 weight constants
# are ~3 MB at L=512 and grow quadratically — long-contig tiles use the
# sliced log-tree path instead.
MM_ENCODE_MAX_L = 1024


def encode_windows(offsets: jax.Array, lengths: jax.Array):
    """[B, L] uint8 offsets -> (hi, lo, valid) over the W = L-K window
    start positions.

    ``valid`` combines the all-8-chars-valid window test with the
    reference's exclusive scan bound p < len-K (kguts.cc:792): the final
    full window of each sequence is deliberately excluded.
    """
    B, L = offsets.shape
    W = L - K
    if W <= 0:
        raise ValueError(f"padded length {L} must exceed {K}")
    from ..params import HI_DIGITS, LO_DIGITS
    pos = jax.lax.broadcasted_iota(jnp.int32, (B, W), 1)
    if L <= MM_ENCODE_MAX_L:
        # Windowed positional encoding as two banded-matrix products:
        # hi[b,i] = sum_j off[b,i+j]*20^(HI-1-j) is a [B,L] @ [L,W]
        # contraction with a banded weight matrix, and the all-valid test
        # is the same band with ones over the invalid indicator — dense
        # matmuls instead of ~16 unaligned window slices.  Exactness:
        # every operand, product, and partial sum is an integer below
        # 2^24, so f32 arithmetic is exact in any accumulation order;
        # HIGHEST precision forces true f32 (TF32's 10 mantissa bits
        # would corrupt every code above 2^11).  Gated by L (the bands
        # are [L, 2W] HLO constants — fine at serving widths,
        # prohibitive for long-contig tiles).
        band_hi, band_lo, band_ones = _encode_bands(L, W)
        off_f = offsets.astype(jnp.float32)
        inv_f = (offsets >= 20).astype(jnp.float32)
        hp = jax.lax.Precision.HIGHEST
        codes = jax.lax.dot(off_f, jnp.asarray(np.concatenate(
            [band_hi, band_lo], axis=1)), precision=hp)
        n_bad = jax.lax.dot(inv_f, jnp.asarray(band_ones), precision=hp)
        hi = codes[:, :W].astype(jnp.int32)
        lo = codes[:, W:].astype(jnp.int32)
        ok = (n_bad < 0.5) & (pos < lengths[:, None] - K)
        return hi, lo, ok
    assert (HI_DIGITS, LO_DIGITS) == (5, 3), "digit tree hardcoded for 5/3"
    off = offsets.astype(jnp.int32)
    # Log-tree digit pairing (wide-tile fallback): build shared 2-/4-digit
    # partial codes instead of naive Horner loops — 5 sliced adds instead
    # of 16, exact in int32 (max hi = 20^5-1).
    p2 = off[:, :-1] * 20 + off[:, 1:]            # digits (i, i+1)
    q4 = p2[:, :-2] * 400 + p2[:, 2:]             # digits (i..i+3)
    hi = q4[:, :W] * 20 + off[:, 4:4 + W]         # digits (i..i+4)
    lo = p2[:, 5:5 + W] * 20 + off[:, 7:7 + W]    # digits (i+5..i+7)
    # validity: window max < 20 via the same pairing (3 sliced maxes)
    m2 = jnp.maximum(off[:, :-1], off[:, 1:])
    m4 = jnp.maximum(m2[:, :-2], m2[:, 2:])
    m8 = jnp.maximum(m4[:, :W], m4[:, 4:4 + W])
    ok = (m8 < 20) & (pos < lengths[:, None] - K)
    return hi, lo, ok


@functools.lru_cache(maxsize=16)
def _encode_bands(L: int, W: int):
    """Banded f32 weight matrices for the windowed encode: column i of
    band_hi holds 20^(HI-1-j) at row i+j (the hi digits of window i),
    band_lo the lo digits, band_ones a K-wide band of ones."""
    from ..params import HI_DIGITS, LO_DIGITS
    band_hi = np.zeros((L, W), np.float32)
    band_lo = np.zeros((L, W), np.float32)
    band_ones = np.zeros((L, W), np.float32)
    cols = np.arange(W)
    for j in range(HI_DIGITS):
        band_hi[cols + j, cols] = float(20 ** (HI_DIGITS - 1 - j))
    for j in range(LO_DIGITS):
        band_lo[cols + HI_DIGITS + j, cols] = float(20 ** (LO_DIGITS - 1 - j))
    for j in range(K):
        band_ones[cols + j, cols] = 1.0
    return band_hi, band_lo, band_ones


def pack_offsets(offsets: np.ndarray) -> np.ndarray:
    """Host-side 5-bit packing of aa offsets (values 0..20): 8 residues
    per 5 bytes, cutting upload bytes 37%.  Length must be a multiple
    of 8 (pad with 20)."""
    B, L = offsets.shape
    if L % 8:
        pad = 8 - L % 8
        offsets = np.concatenate(
            [offsets, np.full((B, pad), 20, np.uint8)], axis=1)
        L += pad
    g = offsets.reshape(B, L // 8, 8).astype(np.uint64)
    v = np.zeros((B, L // 8), dtype=np.uint64)
    for i in range(8):
        v |= g[:, :, i] << np.uint64(5 * i)
    out = np.empty((B, L // 8, 5), dtype=np.uint8)
    for j in range(5):
        out[:, :, j] = (v >> np.uint64(8 * j)).astype(np.uint8)
    return out.reshape(B, -1)


def pack_offsets_planar(offsets: np.ndarray) -> np.ndarray:
    """Host-side planar 5-bit packing: 6 residues per int32 (wire cost
    0.67 B/residue vs 1.0 raw), laid out so the device unpack is pure
    shifts + a concat of CONTIGUOUS blocks (no lane interleave, unlike
    the byte-interleaved pack_offsets scheme).

    Word g holds residues {j*G + g : j in 0..5} where G = ceil(L/6):
    plane j of the unpack is exactly output columns j*G..(j+1)*G."""
    B, L = offsets.shape
    G = -(-L // 6)
    if G * 6 != L:
        offsets = np.concatenate(
            [offsets, np.full((B, G * 6 - L), 20, np.uint8)], axis=1)
    v = np.zeros((B, G), dtype=np.int32)
    for j in range(6):
        v |= offsets[:, j * G:(j + 1) * G].astype(np.int32) << (5 * j)
    return v


def unpack_offsets_planar(packed, L6: int):
    """Device-side inverse of pack_offsets_planar: [B, G] i32 ->
    [B, L6] u8 with L6 = 6*G (padded length; pad columns decode to 20)."""
    G = packed.shape[1]
    assert L6 == 6 * G
    planes = [((packed >> (5 * j)) & 31) for j in range(6)]
    return jnp.concatenate(planes, axis=1).astype(jnp.uint8)


def unpack_offsets(packed, L: int):
    """Device-side inverse of pack_offsets: [B, (L/8)*5] u8 -> [B, L] u8
    (pure vector bit ops)."""
    B = packed.shape[0]
    G = L // 8
    b = packed.reshape(B, G, 5).astype(jnp.int32)
    b0, b1, b2, b3, b4 = (b[:, :, j] for j in range(5))
    a = [
        b0 & 31,
        ((b0 >> 5) | (b1 << 3)) & 31,
        (b1 >> 2) & 31,
        ((b1 >> 7) | (b2 << 1)) & 31,
        ((b2 >> 4) | (b3 << 4)) & 31,
        (b3 >> 1) & 31,
        ((b3 >> 6) | (b4 << 2)) & 31,
        (b4 >> 3) & 31,
    ]
    return jnp.stack(a, axis=-1).reshape(B, L).astype(jnp.uint8)


def _select_payload_row(row, lof, Wd):
    """Match + payload selection over gathered payload-wide-format rows
    [N, 1 + 5*Wd (+pad)]: row = [start, lo plane, fi, oi, avg_off,
    wt-bits planes].  Keys are unique, so at most one lane matches and
    masked sums reproduce the matched values.  Returns flat
    (found, fi, oi, avg_off, wt-bits, idx=start+pos)."""
    left = row[:, 0]
    match = row[:, 1:1 + Wd] == lof[:, None]
    foundf = match.any(axis=-1)
    m = match.astype(jnp.int32)

    def pick(p):
        return (row[:, 1 + p * Wd:1 + (p + 1) * Wd] * m).sum(axis=-1)

    pos = jnp.argmax(match, axis=-1).astype(jnp.int32)
    return (foundf, pick(1), pick(2), pick(3), pick(4), left + pos)


def _pad_flat_probes(hif, lof):
    """Pad flat probe vectors to a gather-friendly length (see
    _probe_count_pad).  Pad rows index row 0 with lo sentinel -2 (never
    matches); callers slice selection outputs back with _unpad_sel."""
    nflat = hif.shape[0]
    npad = _probe_count_pad(nflat)
    if npad == nflat:
        return hif, lof, nflat
    hif = jnp.concatenate([hif, jnp.zeros(npad - nflat, hif.dtype)])
    lof = jnp.concatenate([lof, jnp.full(npad - nflat, -2, lof.dtype)])
    return hif, lof, nflat


def _unpad_sel(sel, nflat):
    return tuple(a[:nflat] for a in sel)


def _finish_select(sel, sh, valid, n):
    """Reshape flat selection results to ``sh`` and apply miss masking
    (fi/oi -> -1, idx -> n)."""
    foundf, fif, oif, avf, wtbits, idxf = sel
    found = valid & foundf.reshape(sh)
    fi = jnp.where(found, fif.reshape(sh), -1)
    oi = jnp.where(found, oif.reshape(sh), -1)
    avg_off = avf.reshape(sh)
    wt = jax.lax.bitcast_convert_type(wtbits.reshape(sh), jnp.float32)
    idx = jnp.where(found, idxf.reshape(sh), n)
    return (found, fi, oi, avg_off, wt, idx)


def probe_windows(ddb: DeviceDB, hi, lo, valid):
    """Batched two-level probe.  Returns (found, fi, oi, avg_off, wt,
    idx), all shaped like ``hi`` (idx = matched DB row, ddb.n if none).

    Semantics: found[b,i] iff the signature DB contains the kmer encoded
    by window (hi,lo)[b,i] — equivalent to lookup_hash_entry >= 0
    (kguts.cc:585-602).
    """
    hi_c = jnp.where(valid, hi, 0)
    lo_c = jnp.where(valid, lo, -2)

    if ddb.fused_wide is not None:
        # Fused packed probe: ONE row gather yields found, fi, wt and the
        # matched row index; oi/avg_off come from a payload gather that
        # XLA dead-code-eliminates whenever the caller ignores those
        # planes (family/fq/best-call paths).  lo_c = -2 maps to low bits
        # 8190 and the sentinel's to 8191, neither a valid lo (< 8000).
        sh = hi_c.shape
        hif, lof, nflat = _pad_flat_probes(hi_c.reshape(-1),
                                           lo_c.reshape(-1))
        row = ddb.fused_wide[hif]              # [N, 1 + 2W (+ pad)]
        Wd = ddb.fused_w
        left = row[:, 0]
        packed = row[:, 1:1 + Wd]
        match = (packed & ((1 << DeviceDB.FUSED_LO_BITS) - 1)) \
            == (lof[:, None] & ((1 << DeviceDB.FUSED_LO_BITS) - 1))
        foundf = match.any(axis=-1)
        m = match.astype(jnp.int32)
        fif = (packed * m).sum(axis=-1) >> DeviceDB.FUSED_LO_BITS
        wtbits = (row[:, 1 + Wd:1 + 2 * Wd] * m).sum(axis=-1)
        pos = jnp.argmax(match, axis=-1).astype(jnp.int32)
        idxf = left + pos
        foundf, fif, wtbits, idxf = _unpad_sel(
            (foundf, fif, wtbits, idxf), nflat)
        found = valid & foundf.reshape(sh)
        fi = jnp.where(found, fif.reshape(sh), -1)
        idx = jnp.where(found, idxf.reshape(sh), ddb.n)
        wt = jax.lax.bitcast_convert_type(
            jnp.where(found, wtbits.reshape(sh), 0), jnp.float32)
        pay = ddb.payload[idx]                 # DCE'd when oi/avg unused
        oi = jnp.where(found, pay[..., 1], -1)
        return (found, fi, oi, pay[..., 2], wt, idx)

    if ddb.payload_wide is not None:
        # Single-gather probe: the row holds [start, lo plane, fi plane,
        # oi plane, avg_off plane, wt-bits plane].  DB keys are unique so
        # at most one slot matches; each payload field is selected with
        # an in-register masked sum (no second gather).  The window axes
        # flatten around the gather+selection (a flat [B*W]-index gather
        # + flat selection).
        sh = hi_c.shape
        hif, lof, nflat = _pad_flat_probes(hi_c.reshape(-1),
                                           lo_c.reshape(-1))
        row = ddb.payload_wide[hif]            # [N, 1 + 5W (+ pad)]
        Wd = ddb.wide_w or (row.shape[-1] - 1) // 5
        sel = _unpad_sel(_select_payload_row(row, lof, Wd), nflat)
        return _finish_select(sel, sh, valid, ddb.n)

    if ddb.sub_blocks is not None:
        # Deep-bucket 2-gather probe: header row -> in-register one-hot
        # pick of the sub-bucket's block id -> payload-wide-format block.
        from ..params import LO_CARD
        sh = hi_c.shape
        hif, lof, nflat = _pad_flat_probes(hi_c.reshape(-1),
                                           lo_c.reshape(-1))
        SUB = ddb.sub_header.shape[1]
        shift = (LO_CARD - 1).bit_length() - (SUB.bit_length() - 1)
        subix = jnp.clip(lof, 0, LO_CARD - 1) >> shift
        hrow = ddb.sub_header[hif]                    # [N, SUB]
        onehot = (subix[:, None] == jax.lax.broadcasted_iota(
            jnp.int32, (1, SUB), 1)).astype(jnp.int32)
        bid = (hrow * onehot).sum(axis=-1)
        row = ddb.sub_blocks[bid]             # [N, 1 + 5*max_sub (+pad)]
        Wd = ddb.sub_w or (row.shape[-1] - 1) // 5
        sel = _unpad_sel(_select_payload_row(row, lof, Wd), nflat)
        return _finish_select(sel, sh, valid, ddb.n)

    if ddb.lo_wide is not None:
        # Wide-bucket compare: one row gather holds the bucket start and
        # the whole sentinel-padded bucket, so matching is a vector
        # equality + argmax — 2 gather ops per probe total (fused row,
        # payload); bucket_pair is never touched.
        row = ddb.lo_wide[hi_c]                    # [..., 1 + WIDE]
        left = row[..., 0]
        match = row[..., 1:] == lo_c[..., None]
        found = valid & match.any(axis=-1)
        pos = jnp.argmax(match, axis=-1).astype(jnp.int32)
        idx = jnp.where(found, left + pos, ddb.n)
    else:
        pair = ddb.bucket_pair[hi_c]
        left = pair[..., 0]
        end = pair[..., 1]
        right = end
        # Branchless lower_bound: after n_steps halvings left==right ==
        # insertion point of lo_c in ddb.lo[left:end).  fori_loop keeps
        # the HLO small.
        def search_step(_, lr):
            left, right = lr
            cont = left < right
            mid = (left + right) >> 1
            v = ddb.lo[jnp.minimum(mid, ddb.n)]
            go_right = cont & (v < lo_c)
            return (jnp.where(go_right, mid + 1, left),
                    jnp.where(cont & ~go_right, mid, right))

        left, right = jax.lax.fori_loop(0, ddb.n_steps, search_step,
                                        (left, right), unroll=False)
        idx = jnp.minimum(left, ddb.n)
        found = valid & (left < end) & (ddb.lo[idx] == lo_c)
        idx = jnp.where(found, idx, ddb.n)
    row = ddb.payload[idx]
    wt = jax.lax.bitcast_convert_type(row[..., 3], jnp.float32)
    return (found, row[..., 0], row[..., 1], row[..., 2], wt, idx)


@functools.partial(jax.jit, static_argnames=("wide_w", "sub_w", "fused_w"))
def _probe_batch_jit(bucket_pair, lo_arr, payload, n, n_steps,
                     offsets, lengths, lo_wide=None, payload_wide=None,
                     wide_w=0, sub_header=None, sub_blocks=None, sub_w=0,
                    fused_wide=None, fused_w=0):
    ddb = DeviceDB(bucket_pair, lo_arr, payload, n_steps, n, lo_wide,
                   payload_wide, wide_w, sub_header, sub_blocks, sub_w,
                   fused_wide, fused_w)
    hi, lo, valid = encode_windows(offsets, lengths)
    return probe_windows(ddb, hi, lo, valid)[:5]


def device_memory_bytes(device=None) -> int:
    """Memory the probe layouts are sized against: the accelerator's
    ``bytes_limit``, or the host's physical memory for a CPU device."""
    device = device or jax.devices()[0]
    if device.platform == "cpu":
        return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    limit = (device.memory_stats() or {}).get("bytes_limit")
    if not limit:
        raise RuntimeError(f"{device} reports no memory limit; the probe "
                           "layouts cannot be sized")
    return int(limit)


def _hit_codes(found: np.ndarray, offsets: np.ndarray):
    """Vectorized (batch_idx, pos, kmer_code) extraction from a probe's
    found plane: Horner re-encode over the K window bytes for hit
    positions only (replaces the per-hit Python K-loop)."""
    bi, pos = np.nonzero(found)
    codes = np.zeros(len(pos), dtype=np.int64)
    for j in range(K):
        codes = codes * 20 + offsets[bi, pos + j]
    return bi, pos, codes


class DeviceEngine:
    """Single-chip batch annotation engine.

    Usage::

        eng = DeviceEngine(db)
        results = eng.process_batch([("id1", "MKLV..."), ...])

    Each result mirrors process_aa_seq outputs: (calls, hits, otu).
    """

    def __init__(self, db: SignatureDB, device=None):
        self.db = db
        self.ddb = DeviceDB.from_db(db, device=device)

    def probe_padded(self, offsets: np.ndarray, lengths: np.ndarray):
        """Run stages 1+2 on a padded uint8 batch; returns numpy arrays
        (found, fi, oi, avg_off, wt) of shape [B, L-K]."""
        d = self.ddb
        out = _probe_batch_jit(d.bucket_pair, d.lo, d.payload, d.n, d.n_steps,
                               jnp.asarray(offsets), jnp.asarray(lengths),
                               d.lo_wide, d.payload_wide, d.wide_w,
                               d.sub_header, d.sub_blocks, d.sub_w,
            d.fused_wide, d.fused_w)
        return tuple(np.asarray(x) for x in out)

    def hits_of_batch(self, seqs: list[str], pad_to: int | None = None):
        """Encode+probe a list of sequences; returns per-sequence hit
        lists of :class:`oracle.Hit` in position order (codes included
        for HIT-line formatting)."""
        B = len(seqs)
        if B == 0:
            return []
        L = max(pad_to or 0, max(len(s) for s in seqs) + 1, K + 2)
        # Round the padded length up to a power of two so repeated calls
        # with varying max lengths share jit cache entries.
        L = 1 << (L - 1).bit_length()
        offsets = np.full((B, L), 20, dtype=np.uint8)
        lengths = np.zeros(B, dtype=np.int32)
        for i, s in enumerate(seqs):
            o = seq_to_offsets(s)
            offsets[i, :len(o)] = o
            lengths[i] = len(o)
        found, fi, oi, avg_off, wt = self.probe_padded(offsets, lengths)
        bi, pos, codes = _hit_codes(found, offsets)
        bounds = np.searchsorted(bi, np.arange(B + 1))
        out = []
        for i in range(B):
            out.append([O.Hit(oI=int(oi[i, p]), pos=int(p),
                              avg_off=int(avg_off[i, p]), fI=int(fi[i, p]),
                              wt=float(wt[i, p]), code=int(c))
                        for p, c in zip(pos[bounds[i]:bounds[i + 1]],
                                        codes[bounds[i]:bounds[i + 1]])])
        return out

    def hit_codes_of_batch(self, seqs: list[str]):
        """Array-native hit extraction for bulk ingest (the NR preload,
        nr_loader.cc:160-183): returns (row_off int64[B+1], codes
        int64[n_hits]) without building any per-hit Python objects."""
        B = len(seqs)
        if B == 0:
            return np.zeros(1, np.int64), np.zeros(0, np.int64)
        offsets, lengths = FastAnnotator.pad_batch(self, seqs)
        found = self.probe_padded(offsets, lengths)[0]
        bi, _pos, codes = _hit_codes(found, offsets)
        row_off = np.searchsorted(bi, np.arange(B + 1)).astype(np.int64)
        return row_off, codes

    def process_batch(self, items: list[tuple[str, str]],
                      params: EngineParams | None = None,
                      want_hits: bool = False, want_otu: bool = True):
        """Full batch annotation: returns a list of (calls, hits, otu)
        per input (id, seq) pair, equal to the oracle's process_aa_seq."""
        params = params or EngineParams()
        hit_lists = self.hits_of_batch([s for _, s in items])
        results = []
        for (seq_id, seq), hits in zip(items, hit_lists):
            calls: list[O.Call] = []
            otu = O.OtuStats() if want_otu else None
            replay_hits(hits, params, calls, otu)
            if otu is not None:
                otu.finalize()
            results.append((calls, hits if want_hits else None, otu))
        return results


class FastAnnotator:
    """High-throughput path: device probe + native C++ scoring.

    Produces the same calls/best-calls as the oracle (the C++ scorer is a
    port of the same state machine; see native/ckmers.cpp), but keeps all
    per-hit work vectorized or native — no per-hit Python.
    """

    def __init__(self, db: SignatureDB, device=None):
        self.db = db
        self.ddb = DeviceDB.from_db(db, device=device)

    def pad_batch(self, seqs: list, pad_to: int | None = None):
        """Pad protein strings OR pre-encoded uint8 offset arrays into a
        [B, L] offsets grid + lengths (invalid=20 padding)."""
        B = len(seqs)
        L = max(pad_to or 0, max((len(s) for s in seqs), default=0) + 1, K + 2)
        L = 1 << (L - 1).bit_length()
        offsets = np.full((B, L), 20, dtype=np.uint8)
        lengths = np.zeros(B, dtype=np.int32)
        for i, s in enumerate(seqs):
            o = s if isinstance(s, np.ndarray) else seq_to_offsets(s)
            offsets[i, :len(o)] = o
            lengths[i] = len(o)
        return offsets, lengths

    def probe_compact(self, offsets: np.ndarray, lengths: np.ndarray,
                      hits_per_seq_cap: int = 64, want_code: bool = True,
                      want_oi: bool = True, want_avg: bool = True,
                      rows_only: bool = False):
        """Device probe + on-device hit compaction.  Returns a dict of
        concatenated per-sequence hit arrays (pos, fi, oi, avg_off, wt,
        code) plus row_off delimiters.  Downloads only the packed hits
        (cap overflow retries with 4x the cap, rounded to a power of two
        to bound recompiles).

        ``rows_only=True`` downloads only (pos, DB-row) and rebuilds
        every plane (fi, oi, avg_off, wt, code) from the host-side DB
        arrays — the minimal wire format for hit-heavy workloads; the
        want_* flags then only pick which keys materialize.

        The ``want_*`` flags drop planes from the download (hit-heavy
        genome workloads move many hits): ``want_code=False`` drops the
        hi/lo kmer-code planes (needed only for HIT lines and
        kmer->family accumulation),
        ``want_oi=False`` the OTU indices (needed only for OTU voting),
        ``want_avg=False`` the avg-offsets (read by the scorer only
        under order_constraint, ckmers.cpp admission drift).  Dropped
        keys come back as zeros so downstream shapes are unchanged."""
        d = self.ddb
        B = offsets.shape[0]
        W = offsets.shape[1] - K
        n_planes = 2 if rows_only \
            else 3 + want_oi + want_avg + 2 * want_code
        max_cap = B * W
        cap = min(max_cap, 1 << (B * hits_per_seq_cap - 1).bit_length())
        while True:
            out = np.asarray(_probe_compact_jit(
                d.bucket_pair, d.lo, d.payload, d.n, d.n_steps,
                jnp.asarray(offsets), jnp.asarray(lengths), cap, d.lo_wide,
                d.payload_wide, d.wide_w, want_code, want_oi, want_avg,
                d.sub_header, d.sub_blocks, d.sub_w,
            d.fused_wide, d.fused_w, rows_only))
            n_hits = out[:B]
            total = int(n_hits.sum())
            if total <= cap or cap >= max_cap:
                break
            cap = min(max_cap, 1 << (total * 4 - 1).bit_length())
        pack = out[B:].reshape(n_planes, cap)
        row_off = np.zeros(B + 1, dtype=np.int64)
        np.cumsum(n_hits, out=row_off[1:])
        t = slice(0, total)
        if rows_only:
            db = self.db
            rows = np.minimum(pack[1, t], max(len(db) - 1, 0))
            h = dict(pos=pack[0, t], row_off=row_off,
                     fi=db.fi[rows], oi=db.oi[rows],
                     avg_off=db.avg_off[rows], wt=db.wt[rows])
            if want_code:
                h["code"] = db.keys[rows]
            return h
        zeros = np.zeros(total, dtype=np.int32)
        h = dict(pos=pack[0, t], fi=pack[1, t], row_off=row_off)
        p = 2
        if want_oi:
            h["oi"], p = pack[p, t], p + 1
        else:
            h["oi"] = zeros
        if want_avg:
            h["avg_off"], p = pack[p, t], p + 1
        else:
            h["avg_off"] = zeros
        h["wt"] = pack[p, t].copy().view(np.float32)
        if want_code:
            h["code"] = (pack[p + 1, t].astype(np.int64) * LO_CARD
                         + pack[p + 2, t].astype(np.int64))
        return h

    def annotate(self, seqs: list[str], params: EngineParams | None = None,
                 max_calls_per_seq: int = 512, want_votes: bool = False):
        """probe + native scoring.  Returns (hits dict, n_calls, call
        arrays (start, end, count, fi, wt), votes)."""
        from ..native import api as native
        params = params or EngineParams()
        offsets, lengths = self.pad_batch(seqs)
        h = self.probe_compact(offsets, lengths)
        n_calls, cs, ce, cc, cf, cw, votes = native.score_batch(
            h["pos"], h["fi"], h["oi"], h["avg_off"], h["wt"], h["row_off"],
            params, max_calls_per_seq, want_votes)
        return h, n_calls, (cs, ce, cc, cf, cw), votes

    def best_calls(self, seqs: list[str], function_of,
                   params: EngineParams | None = None):
        """Batch find_best_call: returns list of oracle.BestCall."""
        from ..native import api as native
        h, n_calls, (cs, ce, cc, cf, cw), _ = self.annotate(seqs, params)
        nf, ofi, ocnt, owt = native.best_call_batch(n_calls, cs, ce, cc, cf, cw)
        return [finish_best_call(int(nf[s]), ofi[s], ocnt[s], owt[s],
                                 function_of) for s in range(len(seqs))]


def finish_best_call(n_funcs: int, fi3, cnt3, wt3, function_of) -> O.BestCall:
    """Final decision step of find_best_call (kguts.cc:1149-1198) applied
    to the native top-3 reduction output."""
    result = O.BestCall(-1, "", 0.0, 0.0, 0.0)
    if n_funcs == 0:
        return result
    if n_funcs == 1:
        score_offset = float(cnt3[0])
    else:
        score_offset = float(cnt3[0] - cnt3[1])
    result.score_offset = score_offset
    if score_offset >= 5.0:
        result.function_index = int(fi3[0])
        result.function = function_of(int(fi3[0]))
        result.score = float(cnt3[0])
        result.weighted_score = float(wt3[0])
    elif n_funcs >= 2:
        f1 = function_of(int(fi3[0]))
        f2 = function_of(int(fi3[1]))
        if f2 > f1:
            f1, f2 = f2, f1
        if n_funcs == 2:
            result.function = f"{f1} ?? {f2}"
            result.score = float(cnt3[0])
        else:
            pair_offset = float(cnt3[1] - cnt3[2])
            if pair_offset > 5.0:
                result.function = f"{f1} ?? {f2}"
                result.score = float(cnt3[0])
                result.score_offset = pair_offset
                result.weighted_score = float(wt3[0])
    return result


@functools.partial(jax.jit,
                   static_argnames=("hit_cap", "wide_w", "want_code",
                                    "want_oi", "want_avg", "sub_w",
                                    "fused_w", "rows_only"))
def _probe_compact_jit(bucket_pair, lo_arr, payload, n, n_steps,
                       offsets, lengths, hit_cap, lo_wide=None,
                       payload_wide=None, wide_w=0, want_code=True,
                       want_oi=True, want_avg=True,
                       sub_header=None, sub_blocks=None, sub_w=0,
                    fused_wide=None, fused_w=0, rows_only=False):
    """Fused probe + on-device hit compaction: hits left-pack into an
    [n_planes, hit_cap] buffer (pos, fi, [oi], [avg_off], wt-bits,
    [hi, lo]) in row-major (= per-sequence, position-ordered) order,
    prefixed by the per-sequence hit counts.  Download cost scales with
    the number of hits instead of six full [B, W] grids — the
    serving-path analogue of the compact CALL download."""
    ddb = DeviceDB(bucket_pair, lo_arr, payload, n_steps, n, lo_wide,
                   payload_wide, wide_w, sub_header, sub_blocks, sub_w,
                   fused_wide, fused_w)
    hi, lo, valid = encode_windows(offsets, lengths)
    found, fi, oi, avg_off, wt, idx = probe_windows(ddb, hi, lo, valid)
    B, W = found.shape
    n_hits = found.sum(axis=1, dtype=jnp.int32)
    flat = found.reshape(-1)
    order = jnp.argsort(~flat, stable=True)[:hit_cap]
    pos = (order % W).astype(jnp.int32)
    if rows_only:
        # 2-plane pack: (window pos, matched DB row) — the host owns the
        # DB arrays, so every payload plane (and the kmer code itself)
        # reconstructs with cheap host gathers; the genome regime's
        # download drops from 3+ planes to 2 with MORE information
        planes = [pos, idx.reshape(-1)[order]]
        return jnp.concatenate([n_hits, jnp.stack(planes).reshape(-1)])
    planes = [pos, fi.reshape(-1)[order]]
    if want_oi:
        planes.append(oi.reshape(-1)[order])
    if want_avg:
        planes.append(avg_off.reshape(-1)[order])
    planes.append(
        jax.lax.bitcast_convert_type(wt.reshape(-1)[order], jnp.int32))
    if want_code:
        planes += [hi.reshape(-1)[order], lo.reshape(-1)[order]]
    return jnp.concatenate([n_hits, jnp.stack(planes).reshape(-1)])


def replay_hits(hits, params: EngineParams, calls, otu) -> None:
    """Drive the exact gather-hits state machine over a precomputed,
    position-ordered hit list.  The machine's transitions depend only on
    the hit sequence (kguts.cc:808-877), so replay is equivalent to the
    inline scan."""
    state = O.GatherState(params)
    for h in hits:
        state.on_hit(h, calls, otu)
    state.finish(calls, otu)
