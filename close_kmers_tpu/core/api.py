"""Engine facade: batch protein annotation with oracle-exact outputs,
backed by the device probe + native C++ scoring.

This is the layer request handlers talk to — the analogue of a
thread-local KmerGuts in the reference's ThreadPool
(/root/reference/threadpool.h:42, threadpool.cc:27-43), except one engine
serves all requests with batched device probes.
"""

from __future__ import annotations

import os

import numpy as np

from ..params import EngineParams
from ..db.signature_db import SignatureDB
from . import oracle as O
from .engine import FastAnnotator, finish_best_call


class AnnotationResult:
    __slots__ = ("seq_id", "seq_len", "calls", "hits", "otu", "best")

    def __init__(self, seq_id, seq_len, calls, hits, otu, best=None):
        self.seq_id = seq_id
        self.seq_len = seq_len
        self.calls = calls
        self.hits = hits
        self.otu = otu
        self.best = best


class KmerEngine:
    """Batch annotation engine with reference-exact semantics."""

    def __init__(self, db: SignatureDB, device=None, mesh=None,
                 device_family: bool = True,
                 device_family_min: int | None = None,
                 routed: bool = False):
        """``mesh``: optional jax Mesh — probe against a range-sharded DB
        over its ("data","table") axes instead of one device.
        ``routed``: with a mesh, probe through the one-gather-per-window
        all_to_all exchange instead of the replicated psum merge.
        ``device_family``: allow the fused device calls+family-rollup
        path for family-mode lookups (annotate_family);
        ``device_family_min``: minimum mapping size (distinct kmers) to
        justify the device fam-table upload (default env
        CLOSE_KMERS_DEVICE_FAMILY_MIN or 50000)."""
        import os
        self.db = db
        if mesh is not None:
            from ..parallel.sharding import ShardedEngine
            self.fa = ShardedEngine(db, mesh, routed=routed)
        else:
            self.fa = FastAnnotator(db, device=device)
        self.function_of = db.function_of
        self.device_family = device_family
        self.device_family_min = device_family_min if device_family_min \
            is not None else int(os.environ.get(
                "CLOSE_KMERS_DEVICE_FAMILY_MIN", 50_000))

    # -- core batch annotation ----------------------------------------------

    def annotate(self, items: list[tuple[str, str]],
                 params: EngineParams | None = None,
                 want_hits: bool = False, want_otu: bool = False,
                 want_best: bool = False,
                 want_code: bool = True) -> list[AnnotationResult]:
        """process_aa_seq for a batch: device probe, native scoring.
        ``hits`` are oracle.Hit lists (populated only if want_hits);
        ``otu`` are finalized OtuStats (only if want_otu);
        ``best`` are BestCall (only if want_best)."""
        return self.annotate_with_hits(items, params, want_hits, want_otu,
                                       want_best, want_code)[0]

    def annotate_with_hits(self, items, params=None, want_hits=False,
                           want_otu=False, want_best=False, want_code=True):
        """annotate() plus the batch's compact hit arrays as an explicit
        return — concurrency-safe (no reliance on the _last_hits stash,
        which a second caller can overwrite between annotate and read).
        ``want_code=False`` lets callers that never touch h["code"]
        (e.g. /query without details) skip the kmer-code download."""
        from ..native import api as native

        params = params or EngineParams()
        seqs = [s for _, s in items]
        if not items:
            return [], dict(row_off=np.zeros(1, np.int64))
        # Bucket B to a power of two (pad with empty sequences): serving
        # batches end with arbitrary-size tails, and every distinct B is
        # a fresh compile.
        B0 = len(seqs)
        Bp = max(16, 1 << (B0 - 1).bit_length())
        offsets, lengths = self.fa.pad_batch(seqs + [""] * (Bp - B0))
        # plane gating (see FastAnnotator.probe_compact): kmer codes feed
        # HIT lines and kmer->peg/family accumulation; avg_off feeds HIT
        # lines and the order_constraint drift test; oi feeds OTU voting.
        h = self.fa.probe_compact(
            offsets, lengths,
            want_code=want_hits or want_code,
            want_oi=want_hits or want_otu,
            want_avg=want_hits or bool(params.order_constraint),
            rows_only=True)   # 2-plane hit download (planes rebuild host-side)
        if Bp != B0:
            # pad rows contribute no hits; trim the row delimiters
            h["row_off"] = h["row_off"][:B0 + 1]
        n_calls, cs, ce, cc, cf, cw, votes = native.score_batch(
            h["pos"], h["fi"], h["oi"], h["avg_off"], h["wt"], h["row_off"],
            params, max_calls_per_seq=max(64, offsets.shape[1] // 4),
            want_votes=want_otu)
        if want_best:
            nf, ofi, ocnt, owt = native.best_call_batch(
                n_calls, cs, ce, cc, cf, cw)
        results = []
        for s, (sid, seq) in enumerate(items):
            calls = [O.Call(int(cs[s, i]), int(ce[s, i]), int(cc[s, i]),
                            int(cf[s, i]), np.float32(cw[s, i]))
                     for i in range(int(n_calls[s]))]
            hits = None
            a, b = int(h["row_off"][s]), int(h["row_off"][s + 1])
            if want_hits:
                hits = [O.Hit(oI=int(h["oi"][k]), pos=int(h["pos"][k]),
                              avg_off=int(h["avg_off"][k]), fI=int(h["fi"][k]),
                              wt=float(h["wt"][k]), code=int(h["code"][k]))
                        for k in range(a, b)]
            otu = None
            if want_otu:
                otu = O.OtuStats()
                for k in range(a, b):
                    if votes[k]:
                        otu.add(int(h["oi"][k]))
                otu.finalize()
            best = None
            if want_best:
                best = finish_best_call(int(nf[s]), ofi[s], ocnt[s], owt[s],
                                        self.function_of)
            results.append(AnnotationResult(sid, len(seq), calls, hits, otu,
                                            best))
        self._last_hits = h  # compact hit arrays for family accumulation
        return results, h

    # -- family-mode lookup (calls + family scores in one device pass) ------

    DEVICE_FAMILY_MAX_D = 32   # dense fam-table fan-out bound (memory)

    def _device_family_scorer(self, mapping):
        """DeviceFamilyScorer for ``mapping``, cached on the mapping and
        invalidated when its CSR rebuilds (every add_fam_mapping clears
        the CSR).  None when the device path doesn't apply: sharded
        engine, disabled, mapping too small to justify the fam-table
        upload, or per-kmer family fan-out too large to densify."""
        if not self.device_family:
            return None
        ddb = getattr(self.fa, "ddb", None)
        if ddb is None:
            return None
        csr = mapping.fam_csr()
        if len(csr[0]) < self.device_family_min:
            return None
        cached = getattr(mapping, "_device_scorer", None)
        if cached is not None and cached[0] is csr:
            return cached[1]
        from .device_family import DeviceFamilyScorer
        # famwide=None: auto-gate the folded single-gather family rows
        # (on the first target they won at the 4096-row serving chunk and
        # lost at 16384; not yet re-measured on the card).
        dfs = DeviceFamilyScorer(self.db, mapping, ddb=ddb, famwide=None)
        if dfs.fdb.d > self.DEVICE_FAMILY_MAX_D:
            dfs = None
        mapping._device_scorer = (csr, dfs)
        return dfs

    def annotate_family(self, items, mapping,
                        params: EngineParams | None = None,
                        want_best: bool = False):
        """Family-mode batch: (results, seq_scores) where seq_scores[s]
        is {family_id: SeqScore} in FIRST-HIT order — byte-compatible
        with family.accumulate_family_scores over the host hit path.

        Uses the fused device calls+rollup program (one probe, ~100 B
        D2H per protein instead of the KB-scale compact hit download)
        when the mapping qualifies; otherwise the compact-hit host path.
        """
        from ..native import api as native
        from .family import SeqScore

        params = params or EngineParams()
        dfs = self._device_family_scorer(mapping) if items else None
        if dfs is None:
            results, h = self.annotate_with_hits(items, params,
                                                 want_best=want_best)
            out_n, fam, hits_c, weight = self.family_scores_batch(mapping, h)
            seq_scores = []
            w = 0
            for s in range(len(items)):
                n = int(out_n[s])
                seq_scores.append({
                    int(fam[w + i]): SeqScore(int(hits_c[w + i]),
                                              int(hits_c[w + i]),
                                              np.float32(weight[w + i]))
                    for i in range(n)})
                w += n
            return results, seq_scores

        from .device_family import DeviceFamilyScorer
        from .device_score import DeviceScorer

        seqs = [s for _, s in items]
        offsets, lengths = self.fa.pad_batch(seqs)
        B = offsets.shape[0]
        ccap = 4
        fcap = None
        while True:
            calls_dev, call_cap, rows_dev, capf = dfs.score_family_packed(
                offsets, lengths, params, ccap, fcap)
            dense = DeviceScorer.unpack_dense(
                np.asarray(calls_dev), B, call_cap)
            roll = DeviceFamilyScorer.finish_rollup_rows(
                np.asarray(rows_dev), capf)
            if dense is None:
                ccap *= 4
                continue
            if roll is None:
                fcap = capf * 4
                dfs._default_cap = max(dfs._default_cap, fcap)
                continue
            break
        n_calls, cs, ce, cc, cf, cw = dense
        if want_best:
            nf, ofi, ocnt, owt = native.best_call_batch(
                n_calls, cs, ce, cc, cf, cw)
        results = []
        for s, (sid, seq) in enumerate(items):
            calls = [O.Call(int(cs[s, i]), int(ce[s, i]), int(cc[s, i]),
                            int(cf[s, i]), np.float32(cw[s, i]))
                     for i in range(int(n_calls[s]))]
            best = finish_best_call(int(nf[s]), ofi[s], ocnt[s], owt[s],
                                    self.function_of) if want_best else None
            results.append(AnnotationResult(sid, len(seq), calls, None,
                                            None, best))
        n_per, fam, counts, weights, first = roll
        seq_scores = []
        k = 0
        for s in range(B):
            n = int(n_per[s])
            order = np.argsort(first[k:k + n], kind="stable")
            seq_scores.append({
                int(fam[k + i]): SeqScore(int(counts[k + i]),
                                          int(counts[k + i]),
                                          np.float32(weights[k + i]))
                for i in order})
            k += n
        return results, seq_scores

    def best_family_matches(self, items, mapping,
                            params: EngineParams | None = None,
                            kmer_hit_threshold: int = 3,
                            allow_ambiguous: bool = False,
                            target_genus_id: int = 0,
                            genus_filter: bool = True):
        """Batch FamilyMapper::find_best_family_match
        (family_mapper.cc:65-205): one fused device pass (calls + family
        rollup) then the vectorized best-match scan — no per-sequence
        Call/dict materialization.  Returns list[family.BestMatch].

        Falls back to annotate_family + the scalar scan when the mapping
        does not qualify for the device rollup."""
        from ..native import api as native
        from .device_family import DeviceFamilyScorer
        from .device_score import DeviceScorer
        from .family import find_best_family_match, \
            find_best_family_matches_batch

        params = params or EngineParams()
        if not items:
            return []
        dfs = self._device_family_scorer(mapping)
        if dfs is None:
            results, seq_scores = self.annotate_family(items, mapping,
                                                       params, want_best=True)
            return [find_best_family_match(
                r.best, seq_scores[i], mapping, kmer_hit_threshold,
                allow_ambiguous, target_genus_id, genus_filter)
                for i, r in enumerate(results)]
        offsets, lengths = self.fa.pad_batch([s for _, s in items])
        return self.best_family_matches_padded(
            offsets, lengths, mapping, params, kmer_hit_threshold,
            allow_ambiguous, target_genus_id, genus_filter)

    def best_family_matches_padded(self, offsets, lengths, mapping,
                                   params: EngineParams | None = None,
                                   kmer_hit_threshold: int = 3,
                                   allow_ambiguous: bool = False,
                                   target_genus_id: int = 0,
                                   genus_filter: bool = True,
                                   as_arrays: bool = False):
        """Array-native best_family_matches: callers with a pre-padded
        [B, L] offsets grid (e.g. the /fq_lookup ORF batcher,
        ops.translate.batch_orf_arrays) skip the per-sequence pad_batch
        copy loop entirely."""
        from ..native import api as native
        from .device_family import DeviceFamilyScorer
        from .device_score import DeviceScorer
        from .family import find_best_family_match, \
            find_best_family_matches_batch

        params = params or EngineParams()
        dfs = self._device_family_scorer(mapping)
        if dfs is None:
            items = [(str(i), offsets[i, :int(lengths[i])])
                     for i in range(offsets.shape[0])]
            results, seq_scores = self.annotate_family(items, mapping,
                                                       params, want_best=True)
            ms = [find_best_family_match(
                r.best, seq_scores[i], mapping, kmer_hit_threshold,
                allow_ambiguous, target_genus_id, genus_filter)
                for i, r in enumerate(results)]
            if as_arrays:
                from .family import BestMatchColumns
                return BestMatchColumns.from_objects(ms)
            return ms

        # Fixed-size chunks (pad the tail with empty sequences): serving
        # batches vary per request and every distinct B is a fresh
        # compile; chunking also lets
        # later dispatches overlap earlier readbacks.  Global packs for
        # both calls and family groups keep D2H proportional to actual
        # output, not B * per-row caps (the tiny-ORF fq regime is
        # output-sparse).  Sticky caps are PER-SEQUENCE so a cap learned
        # on a small chunk scales with the next chunk's B instead of
        # forcing an escalation ladder of fresh compiles; on overflow we
        # jump straight to what the failed readback says is needed.
        B0 = int(offsets.shape[0])
        if B0 == 0:
            if as_arrays:
                from .family import BestMatchColumns
                return BestMatchColumns.from_objects([])
            return []
        CH = self.FAMILY_MATCH_CHUNK
        # Scale the chunk so every dispatch carries ~1.5M windows: fewer
        # wastes the fixed dispatch cost on small-window batches (the
        # /fq_lookup ORF regime, W=57), while more hit a per-protein cost
        # cliff of the rollup's [B*W] sort on the first target (not yet
        # re-measured on the card).  Power-of-2 floor keeps compile counts
        # bounded per workload shape; an explicit FAMILY_MATCH_CHUNK env
        # raises the base.
        W = max(1, offsets.shape[1] - 8)
        CH = min(65536, max(CH, 1 << max(1, (1_500_000 // W).bit_length() - 1)))
        B = CH if B0 > CH else max(256, 1 << max(B0 - 1, 0).bit_length())
        lengths = np.asarray(lengths, dtype=np.int32)
        import jax.numpy as jnp
        from .family import BestCallReduction

        def dispatch(a):
            c_off = offsets[a:a + B]
            c_len = lengths[a:a + B]
            n = c_off.shape[0]
            if n < B:
                pad = np.full((B - n, offsets.shape[1]), 20, np.uint8)
                c_off = np.concatenate([c_off, pad])
                c_len = np.concatenate([c_len,
                                        np.zeros(B - n, np.int32)])
            ccap = getattr(dfs, "_bm_ccap", 1)
            gcap = getattr(dfs, "_bm_gps", 2) * B
            calls_dev, call_cap, rows_dev, _ = dfs.score_family_packed(
                c_off, c_len, params, ccap, -gcap, slim_calls=True)
            return (c_off, c_len, n, calls_dev, call_cap, rows_dev, gcap)

        outs = []

        def process_group(group, joined_dev):
            # One grouped D2H per group: a device-side concatenate makes
            # the chunks' packs a single transfer instead of two per
            # chunk.
            # Overflow retries (rare) fall back to per-chunk readbacks.
            flats = [x for p in group for x in (p[3], p[5])]
            joined = np.asarray(joined_dev)
            sizes = [int(x.shape[0]) for x in flats]
            bounds = np.zeros(len(sizes) + 1, dtype=np.int64)
            np.cumsum(sizes, out=bounds[1:])
            host = [joined[bounds[i]:bounds[i + 1]]
                    for i in range(len(sizes))]
            fold_calls, fold_rows = dfs.pack_flags(offsets.shape[1])
            unpack_calls = DeviceScorer.unpack_dense2 if fold_calls \
                else DeviceScorer.unpack_dense3
            for ci, (c_off, c_len, n, calls_dev, call_cap, rows_dev,
                     gcap) in enumerate(group):
                calls_np = host[2 * ci]
                rows_np = host[2 * ci + 1]
                while True:
                    dense = unpack_calls(calls_np, B, call_cap)
                    roll = DeviceFamilyScorer.finish_rollup_global(
                        rows_np, B, gcap, folded=fold_rows)
                    if dense is not None and roll is not None:
                        break
                    if dense is None:
                        need = -(-int(calls_np[:B].sum()) // B)
                        dfs._bm_ccap = max(call_cap // B * 4, need)
                    if roll is None:
                        need = -(-int(rows_np[:B].sum()) // B)
                        dfs._bm_gps = max(gcap // B * 4, need)
                    calls_dev, call_cap, rows_dev, _ = \
                        dfs.score_family_packed(
                            c_off, c_len, params,
                            getattr(dfs, "_bm_ccap", 1),
                            -getattr(dfs, "_bm_gps", 2) * B,
                            slim_calls=True)
                    gcap = getattr(dfs, "_bm_gps", 2) * B
                    calls_np = np.asarray(calls_dev)
                    rows_np = np.asarray(rows_dev)
                n_calls, cc, cf, cw = dense
                nf, ofi, ocnt, owt = native.best_call_batch(
                    n_calls, None, None, cc, cf, cw)
                n_per, fam, counts, weights, first = roll
                total = int(np.asarray(n_per[:n]).sum())
                # finish THIS chunk's best-match scan now: rows are
                # independent, so running the host scan per chunk
                # overlaps it with the next group's device compute
                # instead of serializing it as a post-loop tail
                # (~0.2-0.3 s per 65k request)
                reduction = BestCallReduction(
                    nf[:n], ofi[:n], ocnt[:n], owt[:n],
                    self.db.functions)
                outs.append(find_best_family_matches_batch(
                    reduction, np.asarray(n_per[:n]), fam[:total],
                    counts[:total], weights[:total], first[:total],
                    mapping, kmer_hit_threshold, allow_ambiguous,
                    target_genus_id, genus_filter,
                    as_arrays=as_arrays))

        # Dispatch-ahead loop: enqueue EVERY
        # chunk up front — uploads and computes chain on the device
        # while the Python thread never blocks — with each GROUP's
        # device concat dispatched EAGERLY (the device executes
        # programs in dispatch order, so a concat enqueued during the
        # drain loop would wait for every later chunk; enqueued here it
        # runs right after its group and its D2H overlaps later
        # groups' compute).  Host finishing (unpack, best-call, match
        # scan) then trails behind the remaining device work.
        GROUP = self.FAMILY_MATCH_GROUP
        groups = []
        pend = []
        for a in range(0, B0, B):
            pend.append(dispatch(a))
            if len(pend) >= GROUP:
                flats = [x for p in pend for x in (p[3], p[5])]
                groups.append((pend, jnp.concatenate(flats)))
                pend = []
        if pend:
            flats = [x for p in pend for x in (p[3], p[5])]
            groups.append((pend, jnp.concatenate(flats)
                           if len(flats) > 1 else flats[0]))
        for group, joined_dev in groups:
            process_group(group, joined_dev)

        if not as_arrays:
            return [m for chunk in outs for m in chunk]
        from .family import BestMatchColumns
        return BestMatchColumns.concat(outs)

    FAMILY_MATCH_CHUNK = int(os.environ.get(
        "CLOSE_KMERS_FAMILY_CHUNK", 4096))
    FAMILY_MATCH_GROUP = int(os.environ.get(
        "CLOSE_KMERS_FAMILY_GROUP", 4))  # chunks per grouped D2H

    def family_scores_batch(self, mapping, h=None) -> tuple:
        """Per-sequence family score accumulation against ``mapping``'s
        CSR.  ``h``: compact hit arrays from annotate_with_hits; defaults
        to the most recent annotate() batch (single-caller use only)."""
        from ..native import api as native
        if h is None:
            h = self._last_hits
        keys, offs, vals = mapping.fam_csr()
        return native.family_scores(h["code"], h["row_off"], keys, offs, vals)

    def hits_compact(self):
        return self._last_hits

    def best_call(self, calls: list[O.Call]) -> O.BestCall:
        return O.find_best_call(calls, self.function_of)
