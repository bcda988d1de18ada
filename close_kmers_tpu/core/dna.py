"""DNA annotation paths: batched six-frame contig processing and
long-contig tiling (the framework's sequence-parallel analogue).

* :func:`annotate_dna_batch` — KmerGuts::process_seq parity
  (/root/reference/kguts.cc:910-937): three forward frames then three
  reverse-complement frames, all feeding one call list / OTU accumulator
  per contig, frames processed in +0,+1,+2,-0,-1,-2 order.

* :func:`probe_long_sequence` — the reference assumes one thread can scan
  an entire chromosome (MAX_SEQ_LEN=5e8, kmer_params.h:6, with per-thread
  scratch that size, kguts.cc:62-65).  On the device we tile: window position i
  depends only on aa[i:i+8], so a long sequence splits into tiles with a
  K-1 overlap ("halo"); every window is probed in exactly one tile, and
  the *sequential* run/gap state machine consumes the concatenated hit
  stream — equal to the untiled scan because scoring depends only on the
  hit sequence (SURVEY.md §5 long-context design).
"""

from __future__ import annotations

import numpy as np

from ..params import K, EngineParams
from ..ops.encoder import seq_to_offsets
from ..ops.translate import rev_comp, translate_kguts
from . import oracle as O


def annotate_dna_batch(engine, items, params: EngineParams | None = None,
                       want_hits: bool = False, want_otu: bool = True):
    """Batch process_seq: returns per-contig (calls, hits, otu) where all
    six frames' results accumulate in frame order into shared lists."""
    from ..native import api as native

    params = params or EngineParams()
    frames_per_contig = []
    flat: list[str] = []
    for _cid, seq in items:
        frames = []
        for off in range(3):
            frames.append(len(flat))
            flat.append(translate_kguts(seq, off))
        rc = rev_comp(seq)
        for off in range(3):
            frames.append(len(flat))
            flat.append(translate_kguts(rc, off))
        frames_per_contig.append(frames)

    if not flat:
        return []
    offsets, lengths = engine.fa.pad_batch(flat)
    h = engine.fa.probe_compact(
        offsets, lengths,
        want_code=want_hits,                      # HIT lines only
        want_oi=want_hits or want_otu,            # OTU voting only
        want_avg=want_hits or bool(params.order_constraint),
        rows_only=True)                           # 2-plane hit download
    n_calls, cs, ce, cc, cf, cw, votes = native.score_batch(
        h["pos"], h["fi"], h["oi"], h["avg_off"], h["wt"], h["row_off"],
        params, max_calls_per_seq=max(64, offsets.shape[1] // 4),
        want_votes=want_otu)

    results = []
    for (cid, seq), frames in zip(items, frames_per_contig):
        calls: list[O.Call] = []
        hits: list[O.Hit] | None = [] if want_hits else None
        otu = O.OtuStats() if want_otu else None
        for fidx in frames:
            for i in range(int(n_calls[fidx])):
                calls.append(O.Call(int(cs[fidx, i]), int(ce[fidx, i]),
                                    int(cc[fidx, i]), int(cf[fidx, i]),
                                    np.float32(cw[fidx, i])))
            a, b = int(h["row_off"][fidx]), int(h["row_off"][fidx + 1])
            if want_hits:
                for k in range(a, b):
                    hits.append(O.Hit(oI=int(h["oi"][k]), pos=int(h["pos"][k]),
                                      avg_off=int(h["avg_off"][k]),
                                      fI=int(h["fi"][k]), wt=float(h["wt"][k]),
                                      code=int(h["code"][k])))
            if want_otu:
                for k in range(a, b):
                    if votes[k]:
                        otu.add(int(h["oi"][k]))
        if otu is not None:
            otu.finalize()
        results.append((calls, hits, otu))
    return results


def probe_long_sequence(engine, seq: str, tile: int = 8192,
                        want_code: bool = True, want_oi: bool = True,
                        want_avg: bool = True, rows_only: bool = True):
    """Tile a long protein sequence into overlapping [tile] chunks (halo
    K-1) and probe them as a batch; returns the merged position-ordered
    hit arrays, identical to an untiled probe.

    Tile t covers absolute window positions [t*step, t*step+step) where
    step = tile - (K-1); the engine's scan-bound exclusion (p < len-K) is
    preserved globally by clipping to the true sequence length.
    ``want_code=False`` skips the kmer-code download (genome workloads
    are download-bound; scoring needs no codes).  ``rows_only`` (default)
    downloads only (pos, DB-row) per hit — 2 planes — and rebuilds the
    payload host-side (engine.FastAnnotator.probe_compact rows_only).
    """
    pI = seq if isinstance(seq, np.ndarray) else seq_to_offsets(seq)
    n = len(pI)
    # halo = K (not K-1): a tile's local scan bound is len-K exclusive
    # (the last-window exclusion, kguts.cc:792), so tile i only covers
    # local positions [0, tile-K); the next tile starts there.
    step = tile - K
    if n <= tile:
        return engine.fa.probe_compact(*engine.fa.pad_batch([seq]),
                                       want_code=want_code,
                                       want_oi=want_oi, want_avg=want_avg,
                                       rows_only=rows_only)

    starts = list(range(0, n, step))
    rows = np.full((len(starts), tile + 1), 20, dtype=np.uint8)
    lens = np.zeros(len(starts), dtype=np.int32)
    for i, s in enumerate(starts):
        chunk = pI[s:s + tile]
        rows[i, :len(chunk)] = chunk
        lens[i] = len(chunk)
    # A tile's scan bound excludes its final K-1+1 windows; the next tile
    # re-covers them via the halo, except the true global tail.  To keep
    # every interior window probed exactly once, tile i contributes
    # positions [0, step) locally; the last tile contributes up to its
    # own scan bound.
    h = engine.fa.probe_compact(rows, lens, want_code=want_code,
                                want_oi=want_oi, want_avg=want_avg,
                                rows_only=rows_only)
    pos = h["pos"]
    row = np.repeat(np.arange(len(starts)), np.diff(h["row_off"]))
    abs_pos = pos.astype(np.int64) + np.asarray(starts, dtype=np.int64)[row]
    keep = (pos < step) | (row == len(starts) - 1)
    # global scan bound (kguts.cc:792): p < n - K
    keep &= abs_pos < n - K
    order = np.argsort(abs_pos[keep], kind="stable")

    def sel(a):
        return a[keep][order]

    out = dict(pos=sel(abs_pos).astype(np.int32), fi=sel(h["fi"]),
               oi=sel(h["oi"]), avg_off=sel(h["avg_off"]), wt=sel(h["wt"]))
    if want_code:
        out["code"] = sel(h["code"])
    out["row_off"] = np.array([0, len(out["pos"])], dtype=np.int64)
    return out


def annotate_long_sequence(engine, seq_id: str, seq: str,
                           params: EngineParams | None = None,
                           tile: int = 8192, want_otu: bool = True):
    """Full long-contig annotation: tiled probe + single sequential scoring
    replay over the merged hit stream."""
    from ..native import api as native

    params = params or EngineParams()
    h = probe_long_sequence(engine, seq, tile, want_code=False,
                            want_oi=want_otu,
                            want_avg=bool(params.order_constraint))
    n_calls, cs, ce, cc, cf, cw, votes = native.score_batch(
        h["pos"], h["fi"], h["oi"], h["avg_off"], h["wt"], h["row_off"],
        params, max_calls_per_seq=65536, want_votes=want_otu)
    calls = [O.Call(int(cs[0, i]), int(ce[0, i]), int(cc[0, i]),
                    int(cf[0, i]), np.float32(cw[0, i]))
             for i in range(int(n_calls[0]))]
    otu = None
    if want_otu:
        otu = O.OtuStats()
        for k in range(len(h["pos"])):
            if votes[k]:
                otu.add(int(h["oi"][k]))
        otu.finalize()
    return calls, otu
