"""Device-resident whole-genome annotation: the entire process_seq
pipeline (6-frame translate + window encode + probe + run/gap scoring)
as ONE jitted program, downloading only the compacted CALL pack.

The reference scans a whole chromosome on one thread against the mmap
hash (KmerGuts::process_seq, /root/reference/kguts.cc:910-937, with
MAX_SEQ_LEN=5e8 scratch buffers, kguts.cc:62-65).  core/dna.py
probe_long_sequence probes on device but downloads every HIT for host
scoring — at genome hit densities that download dominates the pass.
This module keeps scoring on device so only calls (KBs, not MBs) are
copied to the host:

* **Translation on device**: the DNA uploads once as base digits
  (0-3 acgt, 4 ambiguous — ops.translate._DNA_CHAR semantics); the
  reverse-complement digit map is ``3 - d`` and table-11 codon->aa
  becomes five 64-bit boolean functions of the codon index evaluated
  with int32 shifts (no gather).  Byte-equal to
  ops.translate.six_frame_kguts_offsets (tested).
* **Sequence-parallel scoring** (SURVEY.md §5 long-context design):
  each frame tiles into [T, 1016]-window rows scanned in parallel
  lanes; the 13-field scan carry (device_score._scan_score_core) is the
  COMPLETE gather_hits state, so cross-tile exactness comes from a
  device-side fixpoint: scan all tiles with guessed init states, shift
  finals right, repeat until the guesses stop changing.  Tile 0 of each
  frame anchors at the neutral state, so by induction along each chain
  the fixpoint is the exact untiled state assignment — data-dependent
  iteration count (2-3 in practice: any full state reset inside a tile
  cuts the chain), exact on any input.
* **Call compaction**: per-position emissions argsort-pack into one
  [5, cap] buffer (the _probe_score_jit layout) — the only D2H.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..params import K, EngineParams
from .engine import DeviceDB, encode_windows, probe_windows
from .device_score import _scan_score_core, neutral_scan_state

TILE_CHARS = 1024          # <= engine.MM_ENCODE_MAX_L: banded MXU encode
STEP = TILE_CHARS - K      # windows contributed per interior tile
# DNA lengths bucket to multiples of this so distinct genome sizes reuse
# compiles (each bucket is one (N, T) shape).
N_BUCKET = 3 * STEP * 32


def _codon_masks() -> np.ndarray:
    """aa-offset[codon] for the 64 unambiguous codons as five 64-bit
    boolean functions: bit k of the offset == bit ``codon`` of mask k.
    Stored as [5, 2] int32 (lo, hi words)."""
    from ..ops.encoder import AA_TO_OFFSET
    from ..ops.translate import KGUTS_TABLE
    off = AA_TO_OFFSET[KGUTS_TABLE[:64]].astype(np.int64)
    out = np.zeros((5, 2), dtype=np.uint32)
    for k in range(5):
        m = 0
        for idx in range(64):
            m |= ((int(off[idx]) >> k) & 1) << idx
        out[k, 0] = m & 0xFFFFFFFF
        out[k, 1] = m >> 32
    return out.view(np.int32)


_CODON_MASKS = _codon_masks()


def _aa_of_idx4(i4):
    """Table-11 aa offset of codon index i4 in [0, 64) via mask shifts
    (branchless, no gather; arithmetic >> then &1 reads any bit)."""
    lo_sel = i4 < 32
    sh = jnp.where(lo_sel, i4, i4 - 32)
    aa = jnp.zeros_like(i4)
    for k in range(5):
        mlo = jnp.int32(int(_CODON_MASKS[k, 0]))
        mhi = jnp.int32(int(_CODON_MASKS[k, 1]))
        word = jnp.where(lo_sel, mlo, mhi)
        aa = aa | (((word >> sh) & 1) << k)
    return aa


def _frames_of_digits(d, Lpad):
    """[N] int32 digits -> [3, Lpad] aa offsets for reading frames 0,1,2
    (codon i of frame f starts at digit f + 3i).  Digits >= 4 poison
    their codons to offset 20 (ambiguous -> 'x', kguts.cc:530)."""
    i4 = d[:-2] * 16 + d[1:-1] * 4 + d[2:]
    valid = (d[:-2] < 4) & (d[1:-1] < 4) & (d[2:] < 4)
    aa = jnp.where(valid, _aa_of_idx4(i4), 20)
    need = 3 * Lpad
    aa = jnp.concatenate(
        [aa, jnp.full(max(need - aa.shape[0], 0), 20, aa.dtype)])[:need]
    return aa.reshape(Lpad, 3).T


@functools.partial(
    jax.jit,
    static_argnames=("n_db", "n_steps", "min_hits", "min_weighted_hits",
                     "max_gap", "order_constraint", "call_cap",
                     "wide_w", "sub_w", "fused_w"))
def _genome_calls_jit(bucket_pair, lo_arr, payload, n_db, n_steps,
                      digits, n_true,
                      min_hits, min_weighted_hits, max_gap,
                      order_constraint, call_cap,
                      lo_wide=None, payload_wide=None, wide_w=0,
                      sub_header=None, sub_blocks=None, sub_w=0,
                      fused_wide=None, fused_w=0):
    """digits: [N] uint8 base digits padded with 4; n_true: the real DNA
    length.  Returns (packed calls buffer, n_iters) — packed layout:
    [6T] per-row call counts ++ [5*call_cap] (start, end, cnt, fi,
    wt-bits) planes in (frame, position) order."""
    ddb = DeviceDB(bucket_pair, lo_arr, payload, n_steps, n_db, lo_wide,
                   payload_wide, wide_w, sub_header, sub_blocks, sub_w,
                   fused_wide, fused_w)
    N = digits.shape[0]
    Lpad = N // 3
    T = -(-Lpad // STEP)
    d = digits.astype(jnp.int32)
    # reverse complement: flip puts the tail padding at the front;
    # roll it back to the end (pad digits are 4 -> ambiguous codons)
    dc = jnp.roll(jnp.flip(jnp.where(d < 4, 3 - d, 4)),
                  -(jnp.int32(N) - n_true))
    aa6 = jnp.concatenate(
        [_frames_of_digits(d, Lpad), _frames_of_digits(dc, Lpad)], axis=0)

    # tile: row r = (frame r//T, tile r%T) covering frame chars
    # [t*STEP, t*STEP + TILE_CHARS); halo K chars overlap
    padded = jnp.concatenate(
        [aa6, jnp.full((6, (T + 1) * STEP - Lpad), 20, aa6.dtype)], axis=1)
    body = padded[:, :T * STEP].reshape(6, T, STEP)
    halo = padded[:, STEP:STEP + T * STEP].reshape(6, T, STEP)[:, :, :K]
    tiles = jnp.concatenate([body, halo], axis=2).reshape(6 * T, TILE_CHARS)
    tiles = tiles.astype(jnp.uint8)

    r = jnp.arange(6 * T, dtype=jnp.int32)
    frame_of = r // T
    t_of = r % T
    # frame aa lengths (kguts.cc:513-539: floor((n - off) / 3))
    Lf = (n_true - jnp.arange(6, dtype=jnp.int32) % 3) // 3
    tlens = jnp.clip(Lf[frame_of] - t_of * STEP, 0, TILE_CHARS)
    pos0 = t_of * STEP

    hi, lo, valid = encode_windows(tiles, tlens)
    found, p_fi, p_oi, p_av, p_wt, _ = probe_windows(ddb, hi, lo, valid)

    # fixpoint over cross-tile carries (see module docstring)
    neutral = neutral_scan_state(p_fi[:, 0], p_wt[:, 0])
    # A tile with no hits is an identity transfer (every scan update is
    # gated on `h`), so each row's init comes from the nearest PREVIOUS
    # hit-bearing row of its frame — jumping hit-free runs (gene deserts,
    # trailing pad tiles) in one step instead of one iteration per tile.
    row_has = jnp.any(found, axis=1)
    cand = jnp.where(row_has, r, -1).reshape(6, T)
    cummax = jax.lax.associative_scan(jnp.maximum, cand, axis=1)
    prev_idx = jnp.concatenate(
        [jnp.full((6, 1), -1, jnp.int32), cummax[:, :-1]],
        axis=1).reshape(6 * T)

    def shift(fin):
        out = {}
        for k, v in fin.items():
            src = v[jnp.maximum(prev_idx, 0)]
            out[k] = jnp.where(prev_idx < 0, neutral[k], src)
        return out

    def same(a, b):
        ok = jnp.bool_(True)
        for k in a:
            av_, bv = a[k], b[k]
            if av_.dtype == jnp.float32:
                bc = jax.lax.bitcast_convert_type
                ok = ok & jnp.all(bc(av_, jnp.int32) == bc(bv, jnp.int32))
            else:
                ok = ok & jnp.all(av_ == bv)
        return ok

    def body_fn(carry):
        g, _, it = carry
        _, _, fin = _scan_score_core(
            found, p_fi, p_av, p_wt, min_hits, min_weighted_hits,
            max_gap, order_constraint, init=g, pos0=pos0, want_emit=False)
        g2 = shift(fin)
        return g2, same(g2, g), it + 1

    def cond_fn(carry):
        _, done, it = carry
        return (~done) & (it < jnp.int32(T + 2))

    g, _, n_iters = jax.lax.while_loop(
        cond_fn, body_fn, (neutral, jnp.bool_(False), jnp.int32(0)))

    # final emission pass with the exact init states; only each frame's
    # last row performs the end-of-sequence flush (kguts.cc:873-877)
    emit, (c_start, c_end, c_cnt, c_fi, c_wt), _ = _scan_score_core(
        found, p_fi, p_av, p_wt, min_hits, min_weighted_hits, max_gap,
        order_constraint, init=g, pos0=pos0, want_emit=True,
        final_flush=t_of == T - 1)

    n_calls = emit.sum(axis=1, dtype=jnp.int32)
    flat_emit = emit.reshape(-1)
    order = jnp.argsort(~flat_emit, stable=True)[:call_cap]
    pack = jnp.stack([
        c_start.reshape(-1)[order].astype(jnp.int32),
        c_end.reshape(-1)[order].astype(jnp.int32),
        c_cnt.reshape(-1)[order].astype(jnp.int32),
        c_fi.reshape(-1)[order].astype(jnp.int32),
        jax.lax.bitcast_convert_type(c_wt.reshape(-1)[order], jnp.int32),
    ])
    out = jnp.concatenate([n_calls, pack.reshape(-1)])
    return out, n_iters


class GenomeAnnotator:
    """process_seq for whole genomes, device-resident end to end.

    ``calls_of(seq)`` returns the six per-frame call lists in reference
    frame order (+0,+1,+2,-0,-1,-2 — kguts.cc:910-937), each call
    (start, end, count, fI, weighted_f32) with frame-local positions,
    byte-equal to oracle.process_seq's accumulation order."""

    def __init__(self, db_or_engine, device=None):
        ddb = getattr(db_or_engine, "ddb", None)
        if ddb is None:
            fa = getattr(db_or_engine, "fa", None)
            ddb = fa.ddb if fa is not None else DeviceDB.from_db(
                db_or_engine, device=device)
        self.ddb = ddb

    def dispatch(self, seq, params: EngineParams | None = None,
                 call_cap: int = 8192):
        """Launch the device program; returns (device buffer, n_iters
        device scalar, T).  ``seq`` may be str/bytes DNA or a uint8
        digit array (ops.translate._DNA_CHAR encoding)."""
        from ..ops.translate import _DNA_CHAR, _to_bytes
        params = params or EngineParams()
        if isinstance(seq, np.ndarray) and seq.dtype == np.uint8:
            d = seq
        else:
            d = _DNA_CHAR[_to_bytes(seq)]
        n = len(d)
        N = -(-max(n, 1) // N_BUCKET) * N_BUCKET
        if N != n:
            d = np.concatenate([d, np.full(N - n, 4, np.uint8)])
        T = -(-(N // 3) // STEP)
        dd = self.ddb
        out, iters = _genome_calls_jit(
            dd.bucket_pair, dd.lo, dd.payload, dd.n, dd.n_steps,
            jnp.asarray(d), jnp.int32(n),
            params.min_hits, params.min_weighted_hits, params.max_gap,
            params.order_constraint, call_cap,
            dd.lo_wide, dd.payload_wide, dd.wide_w,
            dd.sub_header, dd.sub_blocks, dd.sub_w,
            dd.fused_wide, dd.fused_w)
        return out, iters, T

    @staticmethod
    def finish(out_np: np.ndarray, T: int, call_cap: int):
        """Device buffer -> (n_calls_per_frame [6], per-frame call lists).
        Returns None if call_cap overflowed (caller retries bigger)."""
        n_calls = out_np[:6 * T]
        total = int(n_calls.sum())
        if total > call_cap:
            return None
        pack = out_np[6 * T:].reshape(5, -1)
        per_frame = n_calls.reshape(6, T).sum(axis=1)
        wt = pack[4].view(np.float32)
        frames = []
        k = 0
        for f in range(6):
            m = int(per_frame[f])
            frames.append([(int(pack[0][k + i]), int(pack[1][k + i]),
                            int(pack[2][k + i]), int(pack[3][k + i]),
                            np.float32(wt[k + i])) for i in range(m)])
            k += m
        return per_frame, frames

    def calls_of(self, seq, params: EngineParams | None = None,
                 call_cap: int = 8192):
        out, _, T = self.dispatch(seq, params, call_cap)
        res = self.finish(np.asarray(out), T, call_cap)
        if res is None:
            return self.calls_of(seq, params, call_cap * 4)
        return res
