"""The kser network server: pidgin-HTTP over asyncio.

Protocol parity with KmerRequestServer/KmerRequest2
(/root/reference/kserver.cc, krequest2.cc):

* request line regex ``^([A-Z]+) ([^?#]*)(\\?([^#]*))?(#(.*))? HTTP/(\\d+\\.\\d+)``
  (krequest2.cc:25); query params split on ``;`` or ``&`` (krequest2.cc:115);
* headers lowercased; ``Expect: 100-continue`` honored (krequest2.cc:262-270);
* responses use bare ``\\n`` line endings, ``Content-type: text/plain``,
  and Content-length only on the simple GET responses (krequest2.cc:492-503);
  POST streams close the socket at end like the reference handlers;
* GET routes: /quit /version /genus_lookup/<g> /dump_mapping /dump_sizes
  (krequest2.cc:273-412);
* POST routes: /add /matrix /lookup /fq_lookup /query plus keyed
  ``/mapping/<key>/(add|matrix|lookup)`` universes created on demand
  (krequest2.cc:414-489).

Engine parameters are overridable per request via query params
(?min_hits=3&max_gap=100 — kguts.cc:244-268) and handler options mirror
the reference (kmer_hit_threhsold [sic], find_best_match, find_reps,
allow_ambiguous_functions, target_genus, details, find_best_call, silent).
"""

from __future__ import annotations

import asyncio
import re
import sys
import zlib

import numpy as np

from ..params import EngineParams
from ..core import oracle as O, family as F
from ..core.api import KmerEngine
from ..db.family_db import KmerFamilyMapping, FamilyReps
from ..io.fasta import FastaParser, FastqParser
from ..ops.translate import batch_orf_arrays

REQUEST_RE = re.compile(r"^([A-Z]+) ([^?#]*)(\?([^#]*))?(#(.*))? HTTP/(\d+\.\d+)")
MAPPING_PATH_RE = re.compile(r"^/mapping/([^/]+)(/(add|matrix|lookup))$")
GENUS_PATH_RE = re.compile(r"^/genus_lookup/([^/]+)$")

CHUNK = 1 << 20


class ServerContext:
    """Server state: engine + mapping universes (kserver.cc:31-37)."""

    def __init__(self, engine: KmerEngine, family_mode: bool = False,
                 family_reps: FamilyReps | None = None,
                 kmer_version: str = "", families_version: str = "",
                 batch_size: int = 2048):
        self.engine = engine
        self.family_mode = family_mode
        self.family_reps = family_reps
        self.kmer_version = kmer_version
        self.families_version = families_version
        self.mapping_map: dict[str, KmerFamilyMapping] = {"": KmerFamilyMapping()}
        self.batch_size = batch_size
        self.stop_event = asyncio.Event()
        from ..utils.metrics import Metrics
        self.metrics = Metrics()
        self.checkpoint_dir = "."
        # One compute thread: device dispatches stay serialized (one jit
        # stream) while the event loop keeps parsing/writing other
        # connections during a batch — the asyncio analogue of the
        # reference's IO-thread/worker-pool split (threadpool.cc:18-45).
        import concurrent.futures
        self._compute = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="ck-compute")

    async def annotate(self, items, params, **kw):
        """Run engine.annotate_with_hits on the compute thread; returns
        (results, compact hit arrays).  Hits are returned explicitly —
        with concurrent requests the engine's _last_hits stash may belong
        to another handler by the time this caller resumes."""
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(
            self._compute,
            lambda: self.engine.annotate_with_hits(items, params, **kw))

    async def annotate_family(self, items, mapping, params, **kw):
        """Run engine.annotate_family on the compute thread; returns
        (results, per-sequence {family_id: SeqScore} dicts in first-hit
        order).  Picks the fused device calls+family-rollup program when
        the mapping qualifies (one probe, ~100 B D2H per protein)."""
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(
            self._compute,
            lambda: self.engine.annotate_family(items, mapping, params,
                                                **kw))

    async def best_family_matches(self, items, mapping, params, **kw):
        """Run engine.best_family_matches (fused device pass + vectorized
        best-match scan) on the compute thread."""
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(
            self._compute,
            lambda: self.engine.best_family_matches(items, mapping, params,
                                                    **kw))

    async def best_family_matches_padded(self, offsets, lengths, mapping,
                                         params, **kw):
        """Array-native best_family_matches on the compute thread (the
        /fq_lookup path: a pre-padded ORF grid, no per-item Python)."""
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(
            self._compute,
            lambda: self.engine.best_family_matches_padded(
                offsets, lengths, mapping, params, **kw))

    def checkpoint(self) -> str:
        """Persist the mutable server state (the mapping universes) to a
        checkpoint file — the stand-in for the reference's
        whole-process BLCR checkpoint (krequest2.cc:361-408): the
        signature DB is already a restartable on-disk image, so only the
        dynamically-accumulated mappings need saving."""
        import os
        import pickle
        path = os.path.join(self.checkpoint_dir, f"checkpoint.{os.getpid()}")
        with open(path, "wb") as f:
            pickle.dump(self.mapping_map, f)
        return path

    def restore(self, path: str) -> None:
        import pickle
        with open(path, "rb") as f:
            self.mapping_map = pickle.load(f)

    def mapping(self, key: str) -> KmerFamilyMapping:
        if key not in self.mapping_map:
            self.mapping_map[key] = KmerFamilyMapping()
        return self.mapping_map[key]


async def _write(writer, data: str | bytes):
    if isinstance(data, str):
        data = data.encode("latin-1")
    writer.write(data)
    await writer.drain()


def _status(http_version: str, code: int, status: str) -> str:
    return (f"HTTP/{http_version} {code} {status}\n"
            f"Content-type: text/plain\n")


async def _respond(writer, http_version, code, status, body: str):
    """krequest2.cc:498-520."""
    msg = _status(http_version, code, status)
    msg += f"Content-length: {len(body.encode('latin-1'))}\n\n{body}"
    await _write(writer, msg)


class Request:
    def __init__(self):
        self.type = ""
        self.path = ""
        self.params: dict[str, str] = {}
        self.headers: dict[str, str] = {}
        self.http_version = "1.1"

    def engine_params(self) -> EngineParams:
        return EngineParams.from_query(self.params)

    def int_param(self, name: str, default: int = 0) -> int:
        try:
            return int(self.params.get(name, ""))
        except ValueError:
            return default


async def read_request(reader) -> Request | None:
    line = await reader.readline()
    if not line:
        return None
    line = line.decode("latin-1").rstrip("\r\n")
    m = REQUEST_RE.match(line)
    if not m:
        print(f"Invalid request '{line}'", file=sys.stderr)
        return None
    req = Request()
    req.type = m.group(1)
    req.path = m.group(2)
    req.http_version = m.group(7)
    raw = m.group(4) or ""
    if raw:
        for part in re.split(r"[;&]", raw):
            pos = part.find("=")
            if pos >= 0:
                req.params[part[:pos]] = part[pos + 1:]
    # headers (krequest2.cc:160-252)
    while True:
        hline = await reader.readline()
        if not hline:
            break
        h = hline.decode("latin-1").rstrip("\r\n")
        if not h:
            break
        pos = h.find(":")
        if pos >= 0:
            req.headers[h[:pos].strip().lower()] = h[pos + 1:].strip()
    return req


class BodyStream:
    """Reads exactly content_length bytes in chunks."""

    def __init__(self, reader, content_length: int):
        self.reader = reader
        self.remaining = content_length

    async def chunks(self):
        while self.remaining > 0:
            data = await self.reader.read(min(CHUNK, self.remaining))
            if not data:
                break
            self.remaining -= len(data)
            yield data


# ---------------------------------------------------------------------------
# POST handlers
# ---------------------------------------------------------------------------

async def handle_query(ctx, req, body, writer):
    """/query (query_request.cc:68-152)."""
    params = req.engine_params()
    details = req.int_param("details")
    find_best = req.int_param("find_best_call")
    eng = ctx.engine
    await _write(writer, _status(req.http_version, 200, "OK") + "\n")

    async for items in _fasta_batches(ctx, body):
        out = []
        ctx.metrics.inc("proteins", len(items))
        results, _h = await ctx.annotate(items, params, want_hits=details,
                                         want_otu=True, want_best=find_best,
                                         want_code=bool(details))
        for r in results:
            if find_best:
                if r.best.function:
                    out.append(f"{r.seq_id}\t{r.best.function}\t"
                               f"{O.fmt_float(r.best.score)}\t"
                               f"{O.fmt_float(r.best.weighted_score)}\n")
            else:
                out.append(f"PROTEIN-ID\t{r.seq_id}\t{r.seq_len}\n")
                for c in r.calls:
                    out.append(O.format_call(c, eng.function_of))
                if details:
                    for h in r.hits:
                        out.append(O.format_hit(h, eng.function_of))
                out.append(O.format_otu_stats(r.seq_id, r.seq_len, r.otu))
        await _write(writer, "".join(out))


async def handle_lookup(ctx, req, body, writer, mapping):
    """/lookup (lookup_request.cc)."""
    params = req.engine_params()
    kmer_hit_threshold = req.int_param("kmer_hit_threhsold", 3)  # [sic]
    find_best_match = req.int_param("find_best_match")
    find_reps = req.int_param("find_reps")
    allow_ambig = req.int_param("allow_ambiguous_functions")
    target_genus = req.params.get("target_genus", "")
    target_genus_id = 0
    tg = mapping.lookup_genus(target_genus)
    if tg:
        try:
            target_genus_id = int(tg)
        except ValueError:
            pass
    family_mode = ctx.family_mode
    eng = ctx.engine
    await _write(writer, _status(req.http_version, 200, "OK") + "\n")

    async for items in _fasta_batches(ctx, body):
        out = []
        ctx.metrics.inc("proteins", len(items))
        if family_mode and find_best_match:
            # fused device pass + vectorized best-match scan (no
            # per-protein dict/Call materialization)
            matches = await ctx.best_family_matches(
                items, mapping, params,
                kmer_hit_threshold=kmer_hit_threshold,
                allow_ambiguous=bool(allow_ambig),
                target_genus_id=target_genus_id, genus_filter=True)
            for (sid, _seq), m in zip(items, matches):
                out.append(F.format_best_match_lookup(sid, m))
            await _write(writer, "".join(out))
            continue
        if family_mode:
            results, seq_scores = await ctx.annotate_family(
                items, mapping, params,
                want_best=bool(find_best_match))
        else:
            results, h = await ctx.annotate(items, params)
        for s, r in enumerate(results):
            if family_mode:
                seq_score = seq_scores[s]
            else:
                a, b = int(h["row_off"][s]), int(h["row_off"][s + 1])
                hits = [O.Hit(oI=int(h["oi"][k]), pos=int(h["pos"][k]),
                              avg_off=0, fI=0, wt=0.0, code=int(h["code"][k]))
                        for k in range(a, b)]
                seq_score = F.accumulate_peg_scores(hits, mapping)
            if find_best_match and family_mode:
                m = F.find_best_family_match(
                    r.best, seq_score, mapping, kmer_hit_threshold,
                    allow_ambig, target_genus_id, genus_filter=True)
                out.append(F.format_best_match_lookup(r.seq_id, m))
            else:
                out.append(f"{r.seq_id}\n")
                out.append(F.all_matches_rows(
                    seq_score, mapping, kmer_hit_threshold,
                    family_mode=family_mode,
                    family_reps=ctx.family_reps if find_reps else None))
        await _write(writer, "".join(out))


async def handle_add(ctx, req, body, writer, mapping):
    """/add (add_request.cc:102-229): annotate + ingest into mapping."""
    params = req.engine_params()
    silent = req.int_param("silent")
    eng = ctx.engine
    await _write(writer, _status(req.http_version, 200, "OK") + "\n")

    async for items in _fasta_batches(ctx, body):
        out = []
        ctx.metrics.inc("proteins", len(items))
        results, _h = await ctx.annotate(items, params, want_hits=True,
                                         want_otu=True, want_best=True)
        for r in results:
            if not silent:
                out.append(f"PROTEIN-ID\t{r.seq_id}\t{r.seq_len}\n")
                for c in r.calls:
                    out.append(O.format_call(c, eng.function_of))
                out.append(O.format_otu_stats(r.seq_id, r.seq_len, r.otu))
                fn = r.best.function
                if not fn or " ?? " in fn:
                    fn = "hypothetical protein"
                out.append(f"BEST-CALL\t{r.seq_id}\t{fn}\t"
                           f"{O.fmt_float(r.best.score)}\t"
                           f"{O.fmt_float(r.best.weighted_score)}\t"
                           f"{O.fmt_float(r.best.score_offset)}\n")
            pid = mapping.encode_peg(r.seq_id)
            for hh in r.hits:
                mapping.add_peg_mapping(pid, hh.code)
        await _write(writer, "".join(out))


async def handle_matrix(ctx, req, body, writer, mapping):
    """/matrix (matrix_request.cc): all-vs-all shared-kmer counts.

    The per-hit peg expansion is vectorized: CSR lookup of every hit
    kmer's peg list (one searchsorted + range flatten per protein)
    instead of the reference's per-hit map walk (matrix_request.cc:
    130-161).  Registration order is preserved — a protein's hits only
    count pegs already registered — so the (later, earlier) pair
    orientation matches the reference exactly."""
    params = req.engine_params()
    eng = ctx.engine
    matrix_proteins: dict[int, int] = {}
    distance: dict[tuple[int, int], int] = {}
    member = np.zeros(0, dtype=bool)   # registered-eid mask (grown lazily)

    # /matrix is inherently all-vs-all (the reference buffers every
    # protein in matrix_proteins_ too), so drain the request first and
    # try the device pair program (core/matrix.py) — probe + CSR peg
    # gathers + registration-rank filter + pair sort, one small D2H.
    # Any gate failure (huge degrees, duplicate ids, >2^15 proteins)
    # falls back to the host walk below.
    batches = []
    async for items in _fasta_batches(ctx, body):
        batches.append(items)
    items_all = [it for b in batches for it in b]
    dev = None
    if items_all:
        from ..core.matrix import matrix_distance
        loop = asyncio.get_running_loop()
        dev = await loop.run_in_executor(
            ctx._compute, lambda: matrix_distance(eng, mapping, items_all))
    if dev is not None:
        distance = dev
        for sid, seq in items_all:
            matrix_proteins[mapping.encode_peg(sid)] = len(seq)
        batches = []

    for items in batches:
        _results, h = await ctx.annotate(items, params)
        keys, offs, vals = mapping.peg_csr()
        # the mask must cover every interned peg id the CSR can emit
        # plus the ids this batch will intern
        need = len(mapping.peg_to_id) + len(items) + 1
        if need > len(member):
            grown = np.zeros(2 * need, dtype=bool)
            grown[:len(member)] = member
            member = grown
        for s, (sid, seq) in enumerate(items):
            eid = mapping.encode_peg(sid)
            matrix_proteins[eid] = len(seq)
            member[eid] = True
            a, b = int(h["row_off"][s]), int(h["row_off"][s + 1])
            codes = h["code"][a:b]
            if not (len(keys) and len(codes)):
                continue
            pos = np.searchsorted(keys, codes)
            pos = np.minimum(pos, len(keys) - 1)
            pos = pos[keys[pos] == codes]
            st, en = offs[pos], offs[pos + 1]
            cnts = en - st
            tot = int(cnts.sum())
            if not tot:
                continue
            # flatten the CSR ranges: indices st[i]..en[i] back to back
            base = np.repeat(st - np.concatenate(
                [[0], np.cumsum(cnts)[:-1]]), cnts)
            flat = vals[base + np.arange(tot)]
            sel = flat[(flat != eid) & member[flat]]
            others, counts = np.unique(sel, return_counts=True)
            for o, c in zip(others.tolist(), counts.tolist()):
                key = (eid, int(o))
                distance[key] = distance.get(key, 0) + int(c)

    out = [_status(req.http_version, 200, "OK"), "\n"]
    for (e1, e2) in sorted(distance):
        count = distance[(e1, e2)]
        l1, l2 = matrix_proteins[e1], matrix_proteins[e2]
        score = np.float32(np.float32(count) / np.float32(l1 + l2))
        out.append(f"{mapping.decode_peg(e1)}\t{mapping.decode_peg(e2)}\t"
                   f"{count}\t{O.fmt_float(score)}\n")
    await _write(writer, "".join(out))


async def handle_fq_lookup(ctx, req, body, writer, mapping):
    """/fq_lookup (fq_process_request.cc): FASTQ (maybe gzipped) -> 6-frame
    ORFs -> best family match per ORF -> best frame per read."""
    params = req.engine_params()
    eng = ctx.engine
    await _write(writer, _status(req.http_version, 200, "OK") + "\n")

    reads: list[tuple[str, str]] = []
    parser = FastqParser(on_seq=lambda i, s: reads.append((i, s)))
    decomp = None
    first = True
    async for data in body.chunks():
        if first:
            first = False
            if len(data) >= 2 and data[0] == 0x1F and data[1] == 0x8B:
                decomp = zlib.decompressobj(16 + zlib.MAX_WBITS)
        if decomp is not None:
            buf = data
            text = b""
            while buf:
                text += decomp.decompress(buf)
                if decomp.eof:
                    buf = decomp.unused_data
                    decomp = zlib.decompressobj(16 + zlib.MAX_WBITS)
                else:
                    buf = b""
            parser.parse_chunk(text)
        else:
            parser.parse_chunk(data)
        out = await _process_reads(ctx, reads, params, req)
        reads.clear()
        if out:
            await _write(writer, out)
    parser.parse_complete()
    out = await _process_reads(ctx, reads, params, req)
    reads.clear()
    if out:
        await _write(writer, out)


_FRAME_OF_FPOS = (1, 2, 3, -1, -2, -3)


async def _process_reads(ctx, reads, params, req) -> str:
    """Per-read 6-frame scan (fq_process_request.cc:298-365), array-native:
    the digit-space ORF batcher hands a padded device-ready grid straight
    to the fused family pass, and the best-frame selection runs as a
    (read x frame) reduction, so the host never loops over tokens."""
    if not reads:
        return ""
    mapping = ctx.mapping_map.get("", None)
    kmer_hit_threshold = req.int_param("kmer_hit_threhsold", 3)
    kept = [(ri, rid, seq) for ri, (rid, seq) in enumerate(reads) if rid]
    offsets, lengths, toks = batch_orf_arrays(
        [seq for _, _, seq in kept])
    if offsets.shape[0] == 0:
        return ""
    matches = await ctx.best_family_matches_padded(
        offsets, lengths, mapping, params,
        kmer_hit_threshold=kmer_hit_threshold, genus_filter=False,
        as_arrays=True)
    # array-form result: only the winning frames' tokens materialize
    # BestMatch objects/strings below (a ~0.4 s/pass saving at 100k+
    # ORFs; family.BestMatchColumns)
    scores = matches.score.astype(np.float64)

    # Best-frame selection with the running-score copy quirk
    # (fq_process_request.cc:318-348): running score within a frame is
    # non-decreasing (ORF scores >= 0), so a frame's running max equals
    # its total, strict `>` makes the FIRST max-total frame win, and the
    # captured match list is the winning frame's token prefix up to its
    # LAST positive-score ORF (trailing zero-score ORFs never trigger the
    # snapshot copy).  Equivalence with the reference's token loop is
    # locked by tests/test_server.py's golden yfq/zfq responses and the
    # fq quirk unit test.
    R = len(kept)
    tok_score = np.where(toks["orf"] >= 0, scores[toks["orf"]], 0.0)
    totals = np.zeros((R, 6), dtype=np.float64)
    np.add.at(totals, (toks["read"], toks["fpos"].astype(np.int64)),
              tok_score)
    best_score = totals.max(axis=1)
    win_fpos = np.argmax(totals, axis=1)   # first max wins (strict >)

    # tokens of each read's winning frame, in order
    sel = (toks["fpos"] == win_fpos[toks["read"]]) \
        & (best_score[toks["read"]] > 0.0)
    s_read = toks["read"][sel]
    s_len = toks["len"][sel]
    s_orf = toks["orf"][sel]
    s_score = tok_score[sel]
    # prefix cut: last positive-score token per read
    pos_idx = np.nonzero(s_score > 0)[0]
    last_pos = np.full(R, -1, dtype=np.int64)
    last_pos[s_read[pos_idx]] = pos_idx     # ascending -> last wins
    keep_tok = (np.arange(len(s_read)) <= last_pos[s_read]) & (s_orf >= 0)

    out = []
    k = np.nonzero(keep_tok)[0]
    bounds = np.searchsorted(s_read[k], np.arange(R + 1))
    for rj, (ri, rid, _seq) in enumerate(kept):
        if best_score[rj] <= 0.0:
            continue
        parts = [f"{rid}\t{_FRAME_OF_FPOS[win_fpos[rj]]}\t"
                 f"{'%g' % best_score[rj]}"]
        for t in k[bounds[rj]:bounds[rj + 1]]:
            parts.append(
                f"{s_len[t]}\t"
                f"{F.format_best_match_fq(matches.materialize(int(s_orf[t])))}")
        out.append("\t".join(parts) + "\n")
    return "".join(out)


async def _fasta_batches(ctx, body):
    """Incrementally parse the FASTA body, yielding batches of (id, seq).
    Mirrors the chunked parse→compute→write loop (lookup_request.cc:101-138)."""
    items: list[tuple[str, str]] = []
    parser = FastaParser(on_seq=lambda i, s: items.append((i, s)))
    async for data in body.chunks():
        parser.parse_chunk(data)
        while len(items) >= ctx.batch_size:
            yield items[:ctx.batch_size]
            del items[:ctx.batch_size]
    parser.parse_complete()
    items = [(i, s) for i, s in items if i or s]
    while items:
        yield items[:ctx.batch_size]
        del items[:ctx.batch_size]


# ---------------------------------------------------------------------------
# connection handling
# ---------------------------------------------------------------------------

async def handle_connection(reader, writer, ctx: ServerContext):
    try:
        req = await read_request(reader)
        if req is None:
            return
        if req.headers.get("expect") == "100-continue":
            await _write(writer, f"HTTP/{req.http_version} 100 Continue\n\n")

        ctx.metrics.inc("requests")
        ctx.metrics.inc(f"requests{req.path.split('?')[0]}", 1)
        if req.type == "GET":
            await handle_get(ctx, req, writer)
        elif req.type == "POST":
            cl = req.headers.get("content-length")
            if cl is None:
                await _respond(writer, req.http_version, 500,
                               "Missing content length",
                               "Missing content length header\n")
                return
            body = BodyStream(reader, int(cl))
            key, action = "", req.path
            m = MAPPING_PATH_RE.match(req.path)
            if m:
                key, action = m.group(1), m.group(2)
            mapping = ctx.mapping(key)
            if action == "/add":
                await handle_add(ctx, req, body, writer, mapping)
            elif action == "/matrix":
                await handle_matrix(ctx, req, body, writer, mapping)
            elif action == "/lookup":
                await handle_lookup(ctx, req, body, writer, mapping)
            elif action == "/fq_lookup":
                await handle_fq_lookup(ctx, req, body, writer, mapping)
            elif action == "/query":
                await handle_query(ctx, req, body, writer)
            else:
                await _respond(writer, req.http_version, 404, "Not found",
                               "path not found\n")
    except (ConnectionResetError, BrokenPipeError):
        pass
    except Exception as e:  # 500 wall (krequest2.cc try/catch analogue)
        import traceback
        traceback.print_exc()
        try:
            await _respond(writer, "1.1", 500, "Error", f"error: {e}\n")
        except Exception:
            pass
    finally:
        try:
            writer.close()
            await writer.wait_closed()
        except Exception:
            pass


async def handle_get(ctx, req, writer):
    hv = req.http_version
    if req.path == "/quit":
        await _respond(writer, hv, 200, "OK", "OK, quitting\n")
        ctx.stop_event.set()
        return
    if req.path == "/version":
        out = []
        if ctx.kmer_version:
            out.append(f"kmer\t{ctx.kmer_version}\n")
        if ctx.families_version:
            out.append(f"families\t{ctx.families_version}\n")
        out.append(f"family-mode\t{'1' if ctx.family_mode else '0'}\n")
        await _respond(writer, hv, 200, "OK", "".join(out))
        return
    m = GENUS_PATH_RE.match(req.path)
    if m:
        root = ctx.mapping_map.get("")
        hit = root.genus_map.get(m.group(1)) if root else None
        if hit is None:
            await _respond(writer, hv, 404, "Not Found", "genus not found\n")
        else:
            await _respond(writer, hv, 200, "OK", hit + "\n")
        return
    if req.path == "/dump_mapping":
        # debugging dump to stdout (krequest2.cc:322-348)
        root = ctx.mapping_map.get("")
        from ..ops.encoder import decode_kmer
        for kmer, pegs in root._kmer_to_pegs.items():
            print(decode_kmer(kmer) + "\t" +
                  " ".join(root.decode_peg(p) for p in pegs))
        await _respond(writer, hv, 200, "OK", "Mapping dumped\n")
        return
    if req.path == "/metrics":
        await _respond(writer, hv, 200, "OK", ctx.metrics.render())
        return
    if req.path == "/checkpoint":
        try:
            path = ctx.checkpoint()
            await _respond(writer, hv, 200, "OK", "OK\n")
            print(f"checkpoint written to {path}", file=sys.stderr)
        except Exception as e:
            await _respond(writer, hv, 500, "Error", f"checkpoint failed: {e}\n")
        return
    if req.path == "/dump_sizes":
        out = ["memory dump\n"]
        for key, mapping in ctx.mapping_map.items():
            out.append(f"Mapping '{key}':\n")
            out.append(mapping.dump_sizes())
        await _respond(writer, hv, 200, "OK", "".join(out))
        return
    await _respond(writer, hv, 404, "Not found", "path not found\n")


async def serve(ctx: ServerContext, host: str = "0.0.0.0", port: int = 0,
                port_file: str | None = None):
    """Bind + serve until /quit (kserver.cc:132-214)."""
    server = await asyncio.start_server(
        lambda r, w: handle_connection(r, w, ctx), host, port)
    bound_port = server.sockets[0].getsockname()[1]
    if port_file:
        with open(port_file, "w") as f:
            f.write(f"{bound_port}\n")
    print(f"listening on port {bound_port}", file=sys.stderr)
    async with server:
        await ctx.stop_event.wait()
    return bound_port
