"""Device-resident /matrix pair counting: the all-vs-all shared-kmer
distance workload as ONE jitted program per protein chunk.

The reference implements /matrix as a per-hit std::map walk: every
gathered hit looks up the kmer's peg list and increments a
``map<pair<id,id>, int>`` for each co-registered matrix protein
(/root/reference/matrix_request.cc:130-161), O(hits x degree x log P)
with pointer-chasing on one thread.  The server's host walk
(server/http.py handle_matrix) probes on device but does the CSR
expansion and pair counting in host numpy, which was slower than the
reference architecture on one core.

This module keeps the whole thing on device:

  probe -> matched DB row -> CSR degree/peg gathers (max_deg static
  unrolled) -> registration-rank filter (rank[o] < rank[s]: protein s
  counts only pegs registered before it, never itself — the reference's
  registration-order semantics) -> pack (s_rank << SHIFT | o_rank) ->
  one int32 sort -> run-length boundaries -> compacted (pair, count)
  download (KBs).

Gate conditions (callers fall back to the host path otherwise):
  * total registered proteins P <= 2^15 (pair key packs into int32)
  * CSR max degree <= max_deg bound (default 8; each degree step is one
    flat gather, and signature-kmer NR databases with huge per-kmer peg
    lists would need a different expansion strategy)
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .engine import DeviceDB, encode_windows, probe_windows

PAIR_SHIFT = 15                      # ranks < 2^15; key = s << 15 | o
PAIR_SENTINEL = jnp.int32(1 << 30)   # sorts after every real key


@functools.partial(
    jax.jit,
    static_argnames=("n_db", "n_steps", "max_deg", "pair_cap",
                     "wide_w", "sub_w", "fused_w"))
def _matrix_pairs_jit(bucket_pair, lo_arr, payload, n_db, n_steps,
                      offsets, lengths, rank0, peg_offs, peg_vals, rank,
                      max_deg, pair_cap,
                      lo_wide=None, payload_wide=None, wide_w=0,
                      sub_header=None, sub_blocks=None, sub_w=0,
                      fused_wide=None, fused_w=0):
    """One protein chunk of the matrix program.

    ``peg_offs`` must be padded to [n_db + 2] with its tail repeated so
    the miss row (idx = n_db) decodes as an empty peg range.  ``rank``
    maps peg id -> registration index (or >= 2^15 for pegs that are not
    matrix proteins); ``rank0`` is this chunk's first registration
    index.  Returns a packed [1 + 2*pair_cap] int32 buffer:
    [n_pairs, keys..., counts...]; n_pairs > pair_cap means overflow
    (caller retries with a bigger cap).
    """
    ddb = DeviceDB(bucket_pair, lo_arr, payload, n_steps, n_db, lo_wide,
                   payload_wide, wide_w, sub_header, sub_blocks, sub_w,
                   fused_wide, fused_w)
    B, _L = offsets.shape
    hi, lo, valid = encode_windows(offsets, lengths)
    found, _fi, _oi, _av, _wt, idx = probe_windows(ddb, hi, lo, valid)

    idxf = jnp.where(found, idx, n_db).reshape(-1)          # [B*W]
    st = peg_offs[idxf]
    en = peg_offs[idxf + 1]
    srow = rank0 + jax.lax.broadcasted_iota(
        jnp.int32, (B, hi.shape[1]), 0).reshape(-1)
    n_rank = rank.shape[0]

    keys_parts = []
    for d in range(max_deg):
        has = st + d < en
        peg = peg_vals[jnp.where(has, st + d, 0)]
        orank = rank[jnp.clip(peg, 0, n_rank - 1)]
        ok = has & (orank < srow)   # registered earlier, never self
        keys_parts.append(jnp.where(
            ok, (srow << PAIR_SHIFT) | orank, PAIR_SENTINEL))
    sk = jnp.sort(jnp.concatenate(keys_parts))
    N = sk.shape[0]
    total = jnp.sum((sk < PAIR_SENTINEL).astype(jnp.int32))
    change = jnp.concatenate(
        [jnp.ones(1, bool), sk[1:] != sk[:-1]]) & (sk < PAIR_SENTINEL)
    n_pairs = jnp.sum(change.astype(jnp.int32))
    bpos = jnp.nonzero(change, size=pair_cap, fill_value=N)[0]
    bpos = bpos.astype(jnp.int32)
    ends = jnp.concatenate([bpos[1:], jnp.full(1, N, jnp.int32)])
    counts = jnp.minimum(ends, total) - jnp.minimum(bpos, total)
    keys_out = sk[jnp.minimum(bpos, N - 1)]
    return jnp.concatenate(
        [n_pairs[None], keys_out, counts])


def matrix_distance(eng, mapping, items):
    """Full-request device /matrix for the server handler: returns
    {(eid_s, eid_o): count} with handle_matrix's exact semantics, or
    None when a gate fails (caller falls back to the host walk).

    Gates: P <= 2^15 proteins, unique peg ids, CSR max degree <=
    DeviceMatrix.max_deg, peg-id space <= 2^22, and a signature DB small
    enough that the row-aligned CSR upload stays reasonable (n <= 2^27).
    The mapping's kmer->peg CSR is re-indexed onto signature-DB rows
    (mapping kmers absent from the signature DB can never be probe hits,
    matrix_request.cc:130-140 — on_hit only fires for signature kmers)
    and cached on the DeviceMatrix until the CSR object changes."""
    ddb = getattr(getattr(eng, "fa", None), "ddb", None)
    if ddb is None or ddb.n > (1 << 27):
        return None
    P = len(items)
    if not (0 < P <= (1 << PAIR_SHIFT)):
        return None
    eids = [mapping.encode_peg(sid) for sid, _ in items]
    if len(set(eids)) != P:
        return None
    _keys_m, offs_m, vals_m = mapping.peg_csr()
    n_rank = max(len(mapping.peg_to_id) + 1,
                 (int(vals_m.max()) + 1 if len(vals_m) else 1))
    if n_rank > (1 << 22):
        return None
    dm = getattr(eng, "_device_matrix", None)
    if dm is None:
        dm = eng._device_matrix = DeviceMatrix(eng)
    if len(offs_m) > 1 and dm.max_degree(offs_m) > dm.max_deg:
        return None
    offs_db, vals_db = dm.align_csr_to_db(eng.db.keys, _keys_m,
                                          offs_m, vals_m)
    rank = np.full(n_rank, 1 << 20, dtype=np.int64)
    rank[np.asarray(eids)] = np.arange(P)
    offsets, lengths = eng.fa.pad_batch([s for _, s in items])
    pairs = dm.count_pairs(offsets, lengths, offs_db, vals_db, rank)
    return {(eids[s], eids[o]): c for (s, o), c in pairs.items()}


class DeviceMatrix:
    """Batched /matrix pair counting on device.

    ``count_pairs(offsets, lengths, peg_offs, peg_vals, rank)`` returns
    ({(s_rank, o_rank): count}) with the reference's registration-order
    semantics; proteins are ranked by their row order (the caller
    registers them in arrival order, matrix_request.cc:83-95).
    """

    CHUNK = 2048

    def __init__(self, db_or_engine, max_deg: int = 8, device=None):
        ddb = getattr(db_or_engine, "ddb", None)
        if ddb is None:
            fa = getattr(db_or_engine, "fa", None)
            ddb = fa.ddb if fa is not None else DeviceDB.from_db(
                db_or_engine, device=device)
        self.ddb = ddb
        self.max_deg = max_deg
        self._csr_key = None
        self._dev_csr = None

    def _stage_csr(self, peg_offs: np.ndarray, peg_vals: np.ndarray,
                   rank: np.ndarray):
        """Upload (and cache) the CSR + rank arrays; peg_offs is padded
        so the miss row decodes empty."""
        key = (id(peg_offs), id(peg_vals), id(rank),
               len(peg_offs), len(peg_vals), len(rank))
        if self._csr_key == key:
            return self._dev_csr
        n_db = self.ddb.n
        po = np.asarray(peg_offs)
        if po.dtype != np.int32:
            if po[-1] >= 2**31:
                raise ValueError("CSR too large for int32 offsets")
            po = po.astype(np.int32)
        pad = np.full(n_db + 2 - len(po), po[-1], dtype=np.int32)
        po = np.concatenate([po, pad])
        pv = np.asarray(peg_vals).astype(np.int32)
        if len(pv) == 0:
            pv = np.zeros(1, dtype=np.int32)
        rk = np.asarray(rank).astype(np.int32)
        self._dev_csr = (jnp.asarray(po), jnp.asarray(pv),
                         jnp.asarray(rk))
        self._csr_key = key
        return self._dev_csr

    def max_degree(self, peg_offs: np.ndarray) -> int:
        d = np.diff(peg_offs)
        return int(d.max()) if len(d) else 0

    def align_csr_to_db(self, db_keys: np.ndarray, csr_keys: np.ndarray,
                        csr_offs: np.ndarray, csr_vals: np.ndarray):
        """Re-index a kmer-keyed CSR onto signature-DB row numbers
        (probe_windows returns DB rows, not kmer codes).  Mapping kmers
        absent from the DB are dropped — they can never be hits.
        ``csr_keys`` must be sorted (KmerFamilyMapping._to_csr emits
        sorted keys).  Cached until the CSR object identity changes."""
        key = (id(csr_offs), len(csr_keys), len(csr_vals))
        if getattr(self, "_align_key", None) == key:
            return self._aligned
        n_db = len(db_keys)
        deg = np.diff(csr_offs)
        if len(csr_keys):
            rows = np.searchsorted(db_keys, csr_keys)
            rows_c = np.minimum(rows, n_db - 1)
            ok = (rows < n_db) & (db_keys[rows_c] == csr_keys)
            row_deg = np.zeros(n_db, dtype=np.int64)
            row_deg[rows_c[ok]] = deg[ok]
            vals_db = np.asarray(csr_vals)[np.repeat(ok, deg)]
        else:
            row_deg = np.zeros(n_db, dtype=np.int64)
            vals_db = np.zeros(0, dtype=np.int64)
        offs_db = np.zeros(n_db + 1, dtype=np.int64)
        np.cumsum(row_deg, out=offs_db[1:])
        self._aligned = (offs_db, vals_db)
        self._align_key = key
        return self._aligned

    def count_pairs(self, offsets: np.ndarray, lengths: np.ndarray,
                    peg_offs: np.ndarray, peg_vals: np.ndarray,
                    rank: np.ndarray, pair_cap: int = 32768):
        """Returns dict {(s_rank, o_rank): count} over all chunks."""
        P = offsets.shape[0]
        if P > (1 << PAIR_SHIFT):
            raise ValueError(f"P={P} exceeds the int32 pair-key gate")
        po, pv, rk = self._stage_csr(peg_offs, peg_vals, rank)
        d = self.ddb
        outs = []
        for a in range(0, P, self.CHUNK):
            chunk = offsets[a:a + self.CHUNK]
            lens = lengths[a:a + self.CHUNK]
            if len(chunk) < self.CHUNK:   # pad to one compiled shape
                padn = self.CHUNK - len(chunk)
                chunk = np.concatenate(
                    [chunk, np.full((padn, chunk.shape[1]), 20, np.uint8)])
                lens = np.concatenate(
                    [lens, np.zeros(padn, dtype=lens.dtype)])
            outs.append(_matrix_pairs_jit(
                d.bucket_pair, d.lo, d.payload, d.n, d.n_steps,
                jnp.asarray(chunk), jnp.asarray(lens), jnp.int32(a),
                po, pv, rk, self.max_deg, pair_cap,
                d.lo_wide, d.payload_wide, d.wide_w,
                d.sub_header, d.sub_blocks, d.sub_w,
                d.fused_wide, d.fused_w))
        pairs: dict[tuple[int, int], int] = {}
        for out in outs:
            buf = np.asarray(out)
            n_pairs = int(buf[0])
            if n_pairs > pair_cap:
                return self.count_pairs(offsets, lengths, peg_offs,
                                        peg_vals, rank, pair_cap * 4)
            keys = buf[1:1 + n_pairs]
            counts = buf[1 + pair_cap:1 + pair_cap + n_pairs]
            for k, c in zip(keys.tolist(), counts.tolist()):
                pairs[(k >> PAIR_SHIFT, k & ((1 << PAIR_SHIFT) - 1))] = c
        return pairs
