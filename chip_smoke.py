"""Smoke run of the annotation system on NVIDIA GPUs.

    python chip_smoke.py                one card
    python chip_smoke.py --four-cards   the sharded path on four cards

One card: builds a seeded data directory at the bench corpus size
(70,000 source proteins x 300 aa, ~20M signature kmers, 4,096 functions,
12,288 families with an NR of 24,576 member proteins), starts
``python -m close_kmers_tpu.cli.kser`` on it, and posts ``/query``,
``/lookup?find_best_match=1``, ``/fq_lookup`` and ``/add`` + ``/matrix``.
Every response must be byte-equal to the host reference: core/oracle.py's
state machine over numpy kmer lookups.  After kser exits, the in-process
phases force every probe layout on a DB in its regime (payload_wide on the
bench DB, fused and lo_wide on an 8M-key aa-biased DB, sub and the binary
search on a 15.8M-key DB confined to 1/64 of the hi range with ~2.7k-deep
buckets, famwide on the bench family universe) and check probe planes and
calls against the reference; run whole-genome calling on a 5 Mbp contig
set; and time the scoring scan as the Pallas kernel and as the XLA
lax.scan, alone and inside the fused query program.

Four cards (--four-cards): only the sharded servers, ``kser --shards 4``
(replicated probe, psum merge) and ``kser --shards 4 --routed-probe``
(all_to_all exchange), held to the same reference bytes as the one-card
run, each card's memory in use while they serve, and
``__graft_entry__.dryrun_multichip(4)``.

One process uses a card at a time: the device check runs in a child that
exits before kser starts, and the one-card kser is a child while this
process computes references on the host; in-process device work starts
after it has exited.  The four-card servers run kser's main() in a thread
of this process, so it can read every card's memory while they serve.

The last stdout line is {"ok": true, "device": {...}}.  Any failed phase
exits nonzero without it, and so does a machine where JAX finds no GPU.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import gc
import gzip
import importlib.util
import json
import os
import shutil
import socket
import subprocess
import sys
import threading
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))

import bench  # noqa: E402
from close_kmers_tpu.core import family as F  # noqa: E402
from close_kmers_tpu.core import oracle as O  # noqa: E402
from close_kmers_tpu.db.family_db import KmerFamilyMapping  # noqa: E402
from close_kmers_tpu.db.signature_db import (  # noqa: E402
    SignatureDB, write_index_file)
from close_kmers_tpu.ops.encoder import (  # noqa: E402
    PROT_ALPHA, seq_to_offsets)
from close_kmers_tpu.ops.translate import (  # noqa: E402
    get_possible_proteins, rev_comp, translate_kguts)
from close_kmers_tpu.params import K, EngineParams  # noqa: E402

PARAMS = EngineParams()
N_GENERA = 5
KMER_HIT_THRESHOLD = 3           # /lookup and /fq_lookup default
POW = 20 ** np.arange(K - 1, -1, -1, dtype=np.int64)
# Approximate natural amino-acid frequencies in PROT_ALPHA order
# (scripts/make_scale_db.py)
AA_FREQ = np.array([8.25, 1.38, 5.45, 6.75, 3.86, 7.07, 2.27, 5.96, 5.84,
                    9.66, 2.42, 4.06, 4.70, 3.93, 5.53, 6.56, 5.34, 6.87,
                    1.08, 2.92])
AA_FREQ = AA_FREQ / AA_FREQ.sum()


class SmokeFailure(Exception):
    pass


def log(*a):
    print(*a, flush=True)


def expect(cond, what):
    if not cond:
        raise SmokeFailure(what)


# ---------------------------------------------------------------------------
# device check (in a child process, so the card is free afterwards)
# ---------------------------------------------------------------------------

def check_devices(min_count: int) -> dict:
    code = ("import json, jax; d = jax.devices(); print(json.dumps(dict("
            "platform=d[0].platform, kind=d[0].device_kind, count=len(d), "
            "jax=jax.__version__)))")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600)
    expect(p.returncode == 0, f"JAX failed to start:\n{p.stderr[-3000:]}")
    info = json.loads(p.stdout.strip().splitlines()[-1])
    expect(info["platform"] == "gpu",
           f"no GPU: JAX found {info['platform']} devices only")
    expect(info["count"] >= min_count,
           f"need {min_count} GPUs, JAX found {info['count']}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    log(smi)
    log(f"jax {info['jax']}: {info['count']} x {info['kind']}")
    return info


# ---------------------------------------------------------------------------
# seeded data: the bench corpus as a kser data directory
# ---------------------------------------------------------------------------

def family_layout(n_funcs: int):
    """3 families per function; family 3g+k holds the pegs of source
    proteins g + j*n_funcs for j <= k, so a kmer of source protein g maps
    to three families, of g+n_funcs to two, of g+2*n_funcs to one.
    Returns [(family, source protein, peg id)] in families.dat order."""
    rows = []
    for f in range(3 * n_funcs):
        g, k = divmod(f, 3)
        for j in range(k + 1):
            src = g + j * n_funcs
            rows.append((f, src, f"fig|{src}.{f}.peg.{j}"))
    return rows


def write_data_dir(d: str, n_src: int = bench.N_SRC,
                   prot_len: int = bench.PROT_LEN,
                   n_funcs: int = bench.N_FUNCS, seed: int = 0):
    """Write a kser data directory (SignatureDB.load_dir format plus
    family assets) from the bench corpus.  Returns (db, source proteins
    as uint8 offsets); source proteins below 3 * n_funcs belong to
    families."""
    expect(3 * n_funcs <= n_src, "families need 3 * n_funcs sources")
    os.makedirs(d, exist_ok=True)
    keys, fi, off = bench.source_corpus(np.random.default_rng(seed),
                                        n_src, prot_len, n_funcs)
    functions = [f"fn{i}" for i in range(n_funcs)]
    db = bench.corpus_db(keys, fi, np.random.default_rng(len(keys)),
                         functions)
    np.savez(os.path.join(d, "signature_db.npz"), keys=db.keys, fi=db.fi,
             oi=db.oi, avg_off=db.avg_off, wt=db.wt)
    write_index_file(os.path.join(d, "function.index"), functions)
    write_index_file(os.path.join(d, "otu.index"),
                     [f"otu{i}" for i in range(64)])
    with open(os.path.join(d, "VERSION"), "w") as f:
        f.write("smoke-1\n")
    with open(os.path.join(d, "families.version"), "w") as f:
        f.write("smoke-fam-1\n")
    with open(os.path.join(d, "families.genus_map"), "w") as f:
        for g in range(N_GENERA):
            f.write(f"Genus{g}\t{1000 + g}\n")
    rows = family_layout(n_funcs)
    with open(os.path.join(d, "families.dat"), "w") as f:
        for fam, src, peg in rows:
            f.write(f"GF{fam:08d}\t1\t1\t{peg}\t{prot_len}\t"
                    f"{functions[fam // 3]}\t{fam}\tGenus{fam % N_GENERA}\t"
                    f"{fam}\n")
    with open(os.path.join(d, "families.nr"), "w") as f:
        for _fam, src, peg in rows:
            f.write(f">{peg}\n{offsets_to_str(off[src])}\n")
    return db, off


def offsets_to_str(o: np.ndarray) -> str:
    return "".join(PROT_ALPHA[int(x)] if x < 20 else "X" for x in o)


# ---------------------------------------------------------------------------
# requests
# ---------------------------------------------------------------------------

def protein_mix(rng, off: np.ndarray, n: int, prefix: str):
    """n proteins: whole source proteins, sub-slices, point-mutated
    copies, copies with ambiguity runs, and unrelated random ones."""
    items = []
    for i in range(n):
        src = offsets_to_str(off[int(rng.integers(0, len(off)))])
        kind = rng.random()
        if kind < 0.4:
            s = src
        elif kind < 0.6:
            a = int(rng.integers(0, len(src) - 40))
            s = src[a:a + int(rng.integers(40, len(src) - a + 1))]
        elif kind < 0.8:
            c = list(src)
            for p in rng.choice(len(c), size=int(rng.integers(3, 30)),
                                replace=False):
                c[p] = PROT_ALPHA[int(rng.integers(0, 20))]
            s = "".join(c)
        elif kind < 0.9:
            a = int(rng.integers(0, len(src) - 5))
            s = src[:a] + "X" * int(rng.integers(1, 5)) + src[a + 5:]
        else:
            s = "".join(PROT_ALPHA[int(x)] for x in
                        rng.choice(20, size=int(rng.integers(20, 400)),
                                   p=AA_FREQ))
        items.append((f"{prefix}{i}", s))
    return items


def fasta(items) -> bytes:
    return "".join(f">{i}\n{s}\n" for i, s in items).encode()


def build_requests(off: np.ndarray, n_fam_src: int, seed: int = 1,
                   n_prot: int = 3000, n_reads: int = 4000,
                   n_matrix_src: int = 256):
    """The smoke's requests: [(name, path, body, payload)], payload being
    what the reference needs.  /add and /matrix register and compare
    4 overlapping slices each of n_matrix_src source proteins (peg
    degree <= 4, inside the device pair program's gates)."""
    from fq_bench import synth_reads
    rng = np.random.default_rng(seed)
    q = protein_mix(rng, off, n_prot, "q")
    lk = protein_mix(rng, off[:n_fam_src], n_prot, "l")
    reads = synth_reads(rng, off[:n_fam_src], n_reads, 150)
    fq = "".join(f"@{i}\n{s}\n+\n{'I' * len(s)}\n" for i, s in reads)
    mx = []
    for j, src in enumerate(rng.choice(len(off), size=n_matrix_src,
                                       replace=False)):
        s = offsets_to_str(off[src])
        for k in range(4):
            a = int(rng.integers(0, 120))
            mx.append((f"m{j}.{k}", s[a:a + int(rng.integers(60, 180))]))
    return [
        ("query", "/query", fasta(q), q),
        ("lookup_best", "/lookup?find_best_match=1", fasta(lk), lk),
        ("fq_lookup", "/fq_lookup", gzip.compress(fq.encode()), reads),
        ("add", "/mapping/smoke/add?silent=1", fasta(mx), mx),
        ("matrix", "/mapping/smoke/matrix", fasta(mx), mx),
    ]


# ---------------------------------------------------------------------------
# host reference: the oracle's state machine over numpy lookups
# ---------------------------------------------------------------------------

def window_hits(db: SignatureDB, pI: np.ndarray):
    """Positions, codes and DB rows of the windows gather_hits probes
    (all K residues valid, p < len-K; kguts.cc:783-877) that hit the DB."""
    n = len(pI) - K
    if n <= 0:
        z = np.zeros(0, np.int64)
        return z, z, z
    win = np.lib.stride_tricks.sliding_window_view(pI[:n + K - 1], K)
    ok = win.max(axis=1) < 20
    codes = win.astype(np.int64) @ POW
    rows = np.minimum(np.searchsorted(db.keys, codes), len(db.keys) - 1)
    hit = ok & (db.keys[rows] == codes)
    pos = np.nonzero(hit)[0]
    return pos, codes[pos], rows[pos]


def oracle_scan(db: SignatureDB, pI: np.ndarray, params=PARAMS,
                want_otu=True):
    """(calls, hits, otu) of one sequence: the oracle's GatherState fed
    the numpy hit list (equal to gather_hits, kguts.cc:783-877)."""
    pos, codes, rows = window_hits(db, pI)
    calls, hits = [], []
    otu = O.OtuStats() if want_otu else None
    state = O.GatherState(params)
    for p, c, r in zip(pos.tolist(), codes.tolist(), rows.tolist()):
        h = O.Hit(oI=int(db.oi[r]), pos=p, avg_off=int(db.avg_off[r]),
                  fI=int(db.fi[r]), wt=float(db.wt[r]), code=c)
        hits.append(h)
        state.on_hit(h, calls, otu)
    state.finish(calls, otu)
    if otu is not None:
        otu.finalize()
    return calls, hits, otu


class NumpyHits:
    """load_nr's hit_codes_of_batch interface over window_hits."""

    def __init__(self, db):
        self.db = db

    def hit_codes_of_batch(self, seqs):
        parts = [window_hits(self.db, seq_to_offsets(s))[1] for s in seqs]
        row_off = np.zeros(len(seqs) + 1, dtype=np.int64)
        np.cumsum([len(p) for p in parts], out=row_off[1:])
        return row_off, (np.concatenate(parts) if parts
                         else np.zeros(0, np.int64))


HEADER = "HTTP/1.1 200 OK\nContent-type: text/plain\n\n"


class Reference:
    """Expected response bytes for the smoke's requests."""

    def __init__(self, db: SignatureDB, data_dir: str):
        self.db = db
        self.root = KmerFamilyMapping()
        self.root.load_genus_map(os.path.join(data_dir, "families.genus_map"))
        self.root.load_families(os.path.join(data_dir, "families.dat"))
        self.root.load_nr(os.path.join(data_dir, "families.nr"),
                          NumpyHits(db))
        self.pegs = KmerFamilyMapping()     # the /mapping/smoke universe

    def best_match(self, seq, genus_filter):
        calls, hits, _ = oracle_scan(self.db, seq_to_offsets(seq),
                                     want_otu=False)
        best = O.find_best_call(calls, self.db.function_of)
        return F.find_best_family_match(
            best, F.accumulate_family_scores(hits, self.root),
            self.root, KMER_HIT_THRESHOLD, False, 0, genus_filter)

    def query(self, items):
        out = [HEADER]
        for sid, seq in items:
            calls, _, otu = oracle_scan(self.db, seq_to_offsets(seq))
            out.append(f"PROTEIN-ID\t{sid}\t{len(seq)}\n")
            out.extend(O.format_call(c, self.db.function_of) for c in calls)
            out.append(O.format_otu_stats(sid, len(seq), otu))
        return "".join(out)

    def lookup_best(self, items):
        return HEADER + "".join(
            F.format_best_match_lookup(sid, self.best_match(seq, True))
            for sid, seq in items)

    def fq_lookup(self, reads):
        """fq_process_request.cc:298-365: per read, the frame with the
        first maximal total ORF score wins; its ORFs (> 10 aa) are listed
        up to the last one with a positive score."""
        out = [HEADER]
        for rid, seq in reads:
            if not rid:
                continue
            best_total, best = 0.0, None
            for frame, toks in get_possible_proteins(seq):
                total, listed = 0.0, []
                for tok in toks:
                    if len(tok) > 10:
                        m = self.best_match(tok, False)
                        total += float(m.score)
                        listed.append((len(tok), m))
                if total > best_total:
                    best_total, best = total, (frame, listed)
            if best is None:
                continue
            frame, listed = best
            last = max(i for i, (_, m) in enumerate(listed) if m.score > 0)
            parts = [f"{rid}\t{frame}\t{'%g' % best_total}"]
            parts += [f"{ln}\t{F.format_best_match_fq(m)}"
                      for ln, m in listed[:last + 1]]
            out.append("\t".join(parts) + "\n")
        return "".join(out)

    def add(self, items):
        """/add?silent=1 registers every hit kmer under the protein's peg
        (add_request.cc:102-229) and prints nothing after the header."""
        self.lengths = {}
        self.item_hits = []
        for sid, seq in items:
            _, hits, _ = oracle_scan(self.db, seq_to_offsets(seq),
                                     want_otu=False)
            pid = self.pegs.encode_peg(sid)
            for h in hits:
                self.pegs.add_peg_mapping(pid, h.code)
            self.item_hits.append((sid, seq, hits))
        return HEADER

    def matrix(self, items):
        """matrix_request.cc:130-161 literally: a protein's hits count
        every registered, different peg of the kmer."""
        registered, distance = {}, {}
        for sid, seq, hits in self.item_hits:
            eid = self.pegs.encode_peg(sid)
            registered[eid] = len(seq)
            for h in hits:
                for other in self.pegs.pegs_of_kmer(h.code):
                    if other != eid and other in registered:
                        distance[(eid, other)] = \
                            distance.get((eid, other), 0) + 1
        out = [HEADER]
        for e1, e2 in sorted(distance):
            n = distance[(e1, e2)]
            score = np.float32(np.float32(n) / np.float32(
                registered[e1] + registered[e2]))
            out.append(f"{self.pegs.decode_peg(e1)}\t"
                       f"{self.pegs.decode_peg(e2)}\t{n}\t"
                       f"{O.fmt_float(score)}\n")
        return "".join(out)

    def expected(self, requests):
        t0 = time.time()
        out = {name: getattr(self, name)(payload)
               for name, _path, _body, payload in requests}
        log(f"reference answers computed on the host in "
            f"{time.time() - t0:.1f}s")
        return out


# ---------------------------------------------------------------------------
# serving phase
# ---------------------------------------------------------------------------

def http(port: int, request: bytes, timeout: float = 600) -> bytes:
    with socket.create_connection(("127.0.0.1", port),
                                  timeout=timeout) as s:
        s.sendall(request)
        chunks = []
        while True:
            c = s.recv(1 << 20)
            if not c:
                return b"".join(chunks)
            chunks.append(c)


def post(port, path, body: bytes) -> str:
    req = f"POST {path} HTTP/1.1\nContent-length: {len(body)}\n\n".encode()
    return http(port, req + body).decode("latin-1")


def compare(name, got: str, want: str):
    if got == want:
        return
    g, w = got.splitlines(), want.splitlines()
    k = next((i for i, (a, b) in enumerate(zip(g, w)) if a != b),
             min(len(g), len(w)))
    raise SmokeFailure(
        f"{name}: response differs from the reference at line {k} "
        f"({len(g)} vs {len(w)} lines)\n  got:  {g[k:k + 2]}\n"
        f"  want: {w[k:k + 2]}")


def wait_port(port_file: str, alive, timeout: float) -> int:
    t_end = time.time() + timeout
    while time.time() < t_end:
        if os.path.exists(port_file):
            txt = open(port_file).read().strip()
            if txt:
                return int(txt)
        expect(alive(), "kser exited before it listened")
        time.sleep(0.5)
    raise SmokeFailure(f"kser did not listen within {timeout:.0f}s")


def drive(port, requests, expected, label):
    """Post every request in order and hold each response to its
    reference bytes."""
    for name, path, body, payload in requests:
        t0 = time.time()
        got = post(port, path, body)
        compare(f"{label} {path}", got, expected[name])
        log(f"{label} {path}: {len(payload)} items, "
            f"{len(got.splitlines()) - 3} result lines, byte-equal to the "
            f"reference ({time.time() - t0:.1f}s)")


def serve_subprocess(data_dir, requests, ref_thread, work):
    """kser as a child process (one card), while ``ref_thread`` computes
    the reference answers."""
    port_file = os.path.join(work, "kser.port")
    log_path = os.path.join(work, "kser.log")
    t0 = time.time()
    with open(log_path, "w") as kser_log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "close_kmers_tpu.cli.kser", "0",
             data_dir, "--listen-port-file", port_file],
            cwd=REPO, stdout=kser_log, stderr=subprocess.STDOUT)
        try:
            ref_thread.join()
            expect(ref_thread.error is None,
                   f"reference failed: {ref_thread.error!r}")
            port = wait_port(port_file, lambda: proc.poll() is None, 900)
            log(f"kser listening after {time.time() - t0:.1f}s (load, NR "
                f"preload, warm-up)")
            drive(port, requests, ref_thread.result, "kser")
            http(port, b"GET /quit HTTP/1.1\n\n")
            proc.wait(timeout=120)
            expect(proc.returncode == 0, f"kser exited {proc.returncode}")
        except BaseException:
            sys.stderr.write(open(log_path).read()[-6000:])
            raise
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


class RefThread(threading.Thread):
    def __init__(self, fn):
        super().__init__(daemon=True)
        self.fn, self.result, self.error = fn, None, None

    def run(self):
        try:
            self.result = self.fn()
        except Exception as e:   # reported by the joining phase
            self.error = e


def card_memory():
    import jax
    return [d.memory_stats()["bytes_in_use"] for d in jax.devices()]


def serve_in_process(data_dir, requests, expected, work, extra_args,
                     label):
    """kser's main() in a thread of this process (four cards), so the
    cards' memory can be read while it serves."""
    from close_kmers_tpu.cli import kser
    port_file = os.path.join(work, f"kser_{label}.port")
    t0 = time.time()
    err = []

    def run():
        try:
            kser.main(["0", data_dir, "--listen-port-file", port_file]
                      + extra_args)
        except BaseException as e:
            err.append(e)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    port = wait_port(port_file, lambda: t.is_alive() and not err, 1200)
    log(f"{label}: listening after {time.time() - t0:.1f}s")
    drive(port, requests, expected, label)
    used = card_memory()
    log(f"{label}: bytes in use per card: {used}")
    http(port, b"GET /quit HTTP/1.1\n\n")
    t.join(timeout=120)
    expect(not t.is_alive() and not err, f"{label} kser failed: {err!r}")
    return used


# ---------------------------------------------------------------------------
# in-process device phases (one card)
# ---------------------------------------------------------------------------

def tier_of(ddb) -> str:
    for name in ("payload_wide", "fused_wide", "sub_blocks", "lo_wide"):
        if getattr(ddb, name) is not None:
            return {"fused_wide": "fused", "sub_blocks": "sub"}.get(name,
                                                                    name)
    return "binary"


def pad_queries(seqs):
    # the bench's padding (a multiple of 8 past the longest query): the
    # payload-wide selection compiled for minutes at the power-of-two
    # width 512 on the card (PERF.md)
    L = -(-(max(len(s) for s in seqs) + K) // 8) * 8
    offsets = np.full((len(seqs), L), 20, np.uint8)
    lengths = np.zeros(len(seqs), np.int32)
    for i, s in enumerate(seqs):
        o = s if isinstance(s, np.ndarray) else seq_to_offsets(s)
        offsets[i, :len(o)] = o
        lengths[i] = len(o)
    return offsets, lengths


def check_tier(db, ddb, queries, want_tier, label, n_calls_check=512):
    """Probe planes of every window and the calls of the first
    n_calls_check queries against the reference."""
    import jax.numpy as jnp
    from close_kmers_tpu.core.device_score import DeviceScorer
    from close_kmers_tpu.core.engine import _probe_batch_jit
    tier = tier_of(ddb)
    expect(tier == want_tier, f"{label}: expected the {want_tier} layout, "
                              f"DeviceDB.from_db built {tier}")
    offsets, lengths = pad_queries(queries)
    t0 = time.time()
    d = ddb
    found, fi, oi, av, wt = (np.asarray(x) for x in _probe_batch_jit(
        d.bucket_pair, d.lo, d.payload, d.n, d.n_steps,
        jnp.asarray(offsets), jnp.asarray(lengths), d.lo_wide,
        d.payload_wide, d.wide_w, d.sub_header, d.sub_blocks, d.sub_w,
        d.fused_wide, d.fused_w))
    W = found.shape[1]
    ref = np.zeros_like(found)
    n_hits = 0
    for b in range(len(queries)):
        pos, _codes, rows = window_hits(db, offsets[b, :lengths[b]])
        ref[b, pos] = True
        n_hits += len(pos)
        for plane, want in ((fi, db.fi), (oi, db.oi), (av, db.avg_off),
                            (wt, db.wt)):
            expect(np.array_equal(plane[b, pos], want[rows]),
                   f"{label}: probe payload differs in query {b}")
    expect(np.array_equal(found, ref[:, :W]),
           f"{label}: probe hits differ ({int(found.sum())} vs "
           f"{int(ref.sum())})")
    ds = DeviceScorer(db, ddb=ddb)
    n_calls, calls = ds.score_batch(offsets[:n_calls_check],
                                    lengths[:n_calls_check], PARAMS)
    n_ref = 0
    for b in range(min(n_calls_check, len(queries))):
        want, _, _ = oracle_scan(db, offsets[b, :lengths[b]],
                                 want_otu=False)
        n_ref += len(want)
        expect([tuple(c) for c in calls[b]]
               == [(c.start, c.end, c.count, c.fI, np.float32(c.weighted))
                   for c in want], f"{label}: calls differ in query {b}")
    log(f"tier {tier:12s} {label}: {len(db):,} keys, max bucket "
        f"{db.max_bucket}, {n_hits:,} probe hits and {n_ref} calls equal "
        f"to the reference ({time.time() - t0:.1f}s)")


def aa_biased_db(rng, n_draw, first=None, second=None, group=64):
    """Signature DB over n_draw aa-frequency-biased 8-mers (duplicates
    dropped).  first/second pin the leading residues (a hi-range slice).
    Functions come in groups of ``group`` keys so chained kmers of one
    group make same-function hit runs."""
    r = rng.choice(20, size=(n_draw, K), p=AA_FREQ).astype(np.int64)
    if first is not None:
        r[:, 0] = first
    if second is not None:
        p = AA_FREQ[second] / AA_FREQ[second].sum()
        r[:, 1] = np.asarray(second)[rng.choice(len(second), size=n_draw,
                                                p=p)]
    keys = np.unique(r @ POW)
    n = len(keys)
    perm = rng.permutation(n)
    fi = np.empty(n, np.int32)
    fi[perm] = (np.arange(n) // group) % 5000
    return SignatureDB(keys, fi,
                       rng.integers(-1, 64, size=n).astype(np.int32),
                       rng.integers(0, 300, size=n).astype(np.int32),
                       rng.uniform(0.1, 4.0, size=n).astype(np.float32)), perm


def kmer_chain_queries(rng, db, perm, n, group=64):
    """Queries spelled from kmers of one function group (hits every K
    positions, same function), some with mutations, plus random ones."""
    from close_kmers_tpu.ops.encoder import decode_kmer
    out = []
    n_groups = len(perm) // group
    for i in range(n):
        if i % 8 == 7:
            out.append("".join(PROT_ALPHA[int(x)] for x in
                               rng.choice(20, size=200, p=AA_FREQ)))
            continue
        g = int(rng.integers(0, n_groups))
        members = perm[g * group:(g + 1) * group]
        pick = rng.choice(members, size=int(rng.integers(6, 36)),
                          replace=False)
        s = list("".join(decode_kmer(int(db.keys[k])) for k in pick))
        if i % 3 == 0:
            for p in rng.choice(len(s), size=3, replace=False):
                s[p] = PROT_ALPHA[int(rng.integers(0, 20))]
        out.append("".join(s))
    return out


def tiers_phase(db_bench, off, mid_draws, deep_draws, min_deep_keys):
    """Every probe layout on a DB of its regime, auto-picked where the
    ladder picks it.  The mid DB pins the first residue (1/20 of the hi
    range, buckets up to ~100 deep); the deep DB pins the first two
    (48,000 buckets, 1/64 of the range, as one shard of a full-density
    DB), up to ~2.7k deep."""
    from close_kmers_tpu.core.engine import DeviceDB
    rng = np.random.default_rng(11)
    qs = [s[:off.shape[1]] for _, s in protein_mix(rng, off, 4096, "t")]
    check_tier(db_bench, DeviceDB.from_db(db_bench), qs, "payload_wide",
               "bench DB (auto)")

    t0 = time.time()
    db_mid, perm = aa_biased_db(rng, mid_draws, first=9)
    log(f"aa-biased mid DB drawn in {time.time() - t0:.1f}s")
    qs = kmer_chain_queries(rng, db_mid, perm, 4096)
    check_tier(db_mid, DeviceDB.from_db(db_mid), qs, "fused",
               "aa-biased DB (auto)")
    check_tier(db_mid, DeviceDB.from_db(db_mid, fused=False, sub=False),
               qs, "lo_wide", "aa-biased DB (fused, sub off)")
    del db_mid

    t0 = time.time()
    # 1/64 of the hi range: first residue L, second in A..G (48k buckets)
    db_deep, perm = aa_biased_db(rng, deep_draws, first=9,
                                 second=list(range(6)))
    log(f"deep DB drawn in {time.time() - t0:.1f}s")
    expect(len(db_deep) >= min_deep_keys,
           f"deep DB too small: {len(db_deep)} keys")
    qs = kmer_chain_queries(rng, db_deep, perm, 4096)
    check_tier(db_deep, DeviceDB.from_db(db_deep), qs, "sub",
               "deep DB (auto)")
    check_tier(db_deep, DeviceDB.from_db(db_deep, sub=False, wide_lo=False),
               qs, "binary", "deep DB (sub, lo_wide off)")


def famwide_phase(db_bench, off, n_items):
    """Family best-match through the folded single-gather famwide rows
    on the bench family universe, against the reference scan."""
    from close_kmers_tpu.core.api import KmerEngine
    from close_kmers_tpu.core.device_family import DeviceFamilyScorer
    rng = np.random.default_rng(12)
    dbf, mapping = bench.make_family_universe(db_bench, rng)
    # the universe is one bulk CSR: give the host lookups
    # (families_of_kmer) the same one
    mapping._bulk_fam = mapping._fam_csr
    eng = KmerEngine(dbf)
    auto = eng._device_family_scorer(mapping)
    log(f"bench family universe: the serving engine's auto gate "
        f"{'builds' if auto.famwide is not None else 'skips'} famwide rows")
    dfs = DeviceFamilyScorer(dbf, mapping, ddb=eng.fa.ddb, famwide=True)
    expect(dfs.famwide is not None, "famwide rows could not be built")
    mapping._device_scorer = (mapping.fam_csr(), dfs)
    items = protein_mix(rng, off, n_items, "f")
    t0 = time.time()
    got = eng.best_family_matches(items, mapping,
                                  kmer_hit_threshold=KMER_HIT_THRESHOLD)
    for (sid, seq), m in zip(items, got):
        calls, hits, _ = oracle_scan(dbf, seq_to_offsets(seq),
                                     want_otu=False)
        want = F.find_best_family_match(
            O.find_best_call(calls, dbf.function_of),
            F.accumulate_family_scores(hits, mapping), mapping,
            KMER_HIT_THRESHOLD, False, 0, True)
        expect(F.format_best_match_lookup(sid, m)
               == F.format_best_match_lookup(sid, want),
               f"famwide: best match differs for {sid}")
    log(f"tier famwide      bench family universe: {len(items)} best "
        f"matches equal to the reference (D={dfs.fam_d}, "
        f"{time.time() - t0:.1f}s)")


def genome_phase(db_bench, off, n_contigs, contig_bp):
    from dna_bench import synth_genome
    from close_kmers_tpu.core.genome import GenomeAnnotator
    rng = np.random.default_rng(13)
    ga = GenomeAnnotator(db_bench)
    n_calls = 0
    t0 = time.time()
    for c in range(n_contigs):
        contig = synth_genome(rng, off, contig_bp)
        _per_frame, frames = ga.calls_of(contig)
        rc = rev_comp(contig)
        for f, (src, k) in enumerate([(contig, 0), (contig, 1), (contig, 2),
                                      (rc, 0), (rc, 1), (rc, 2)]):
            want, _, _ = oracle_scan(
                db_bench, seq_to_offsets(translate_kguts(src, k)),
                want_otu=False)
            expect(frames[f] == [(c_.start, c_.end, c_.count, c_.fI,
                                  np.float32(c_.weighted)) for c_ in want],
                   f"genome: contig {c} frame {f} calls differ")
            n_calls += len(want)
    log(f"genome process_seq: {n_contigs} contigs x {contig_bp:,} bp, "
        f"{n_calls} calls equal to the reference ({time.time() - t0:.1f}s)")


def median_ms(fn, *args, n=20):
    import jax
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    ts.sort()
    return 1e3 * ts[len(ts) // 2], 1e3 * (ts[3 * n // 4] - ts[n // 4])


@contextlib.contextmanager
def xla_scan():
    """Trace programs with the lax.scan scoring in place of the kernel
    (only for the timing comparison below)."""
    from close_kmers_tpu.core import device_score as DS
    saved = DS._scan_score
    DS._scan_score = DS._scan_score_xla
    try:
        yield
    finally:
        DS._scan_score = saved


def kernel_phase(db_bench, off):
    """Scoring scan at B = 4096, W = 300: the Pallas kernel vs the XLA
    lax.scan, alone and inside the fused query program."""
    import jax
    import jax.numpy as jnp
    from close_kmers_tpu.core import device_score as DS
    from close_kmers_tpu.core.engine import DeviceDB
    rng = np.random.default_rng(14)
    B, W = 4096, 300
    p = dict(min_hits=PARAMS.min_hits,
             min_weighted_hits=PARAMS.min_weighted_hits,
             max_gap=PARAMS.max_gap, order_constraint=PARAMS.order_constraint)
    args = (jnp.asarray(rng.random((B, W)) < 0.6),
            jnp.asarray(rng.integers(0, 3, (B, W)).astype(np.int32)),
            jnp.asarray(rng.integers(0, 300, (B, W)).astype(np.int32)),
            jnp.asarray(rng.uniform(0.1, 3, (B, W)).astype(np.float32)))
    kern = jax.jit(functools.partial(DS._scan_score, **p))
    xla = jax.jit(functools.partial(DS._scan_score_xla, **p))
    ek, fk = kern(*args)
    ex, fx = xla(*args)
    m = np.asarray(ex)
    expect(np.array_equal(np.asarray(ek), m) and all(
        np.array_equal(np.asarray(a)[m], np.asarray(b)[m])
        for a, b in zip(fk, fx)), "scan kernel differs from lax.scan")
    alone_k, alone_x = median_ms(kern, *args), median_ms(xla, *args)

    d = DeviceDB.from_db(db_bench)
    q = np.full((B, 304), 20, np.uint8)
    q[:, :300] = off[rng.integers(0, len(off), B)]
    qa, qla = jnp.asarray(q), jnp.asarray(np.full(B, 300, np.int32))
    cap = int(B * 1.3)

    def fused(o, ln):
        return DS._probe_score_jit.__wrapped__(
            d.bucket_pair, d.lo, d.payload, d.n, d.n_steps, o, ln,
            PARAMS.min_hits, PARAMS.min_weighted_hits, PARAMS.max_gap,
            PARAMS.order_constraint, cap, 0, d.lo_wide, 1, d.payload_wide,
            d.wide_w, d.sub_header, d.sub_blocks, d.sub_w, d.fused_wide,
            d.fused_w, 2)[0]

    fused_k = jax.jit(fused)
    text = fused_k.trace(qa, qla).lower(
        lowering_platforms=("cuda",)).as_text()
    expect("__gpu$xla.gpu.triton" in text,
           "the fused query program lowered for the GPU has no Triton "
           "kernel")
    out_k = np.asarray(fused_k(qa, qla))
    with xla_scan():
        fused_x = jax.jit(lambda o, ln: fused(o, ln))
        out_x = np.asarray(fused_x(qa, qla))
    expect(np.array_equal(out_k, out_x),
           "fused query program: kernel and lax.scan outputs differ")
    e2e = [median_ms(fused_x, qa, qla), median_ms(fused_k, qa, qla),
           median_ms(fused_k, qa, qla), median_ms(fused_x, qa, qla)]
    log(f"scan alone   B={B} W={W}: kernel {alone_k[0]:.3f} ms "
        f"(iqr {alone_k[1]:.3f}), lax.scan {alone_x[0]:.3f} ms "
        f"(iqr {alone_x[1]:.3f})")
    log("fused query program B=4096 (median ms, iqr) in turns "
        "lax.scan/kernel/kernel/lax.scan: "
        + ", ".join(f"{a:.3f} ({b:.3f})" for a, b in e2e))
    log("the lowered GPU query program carries the Triton scan kernel "
        "(__gpu$xla.gpu.triton)")


# ---------------------------------------------------------------------------

FULL = dict(n_src=bench.N_SRC, n_funcs=bench.N_FUNCS, n_prot=3000,
            n_reads=4000, n_matrix_src=256, mid_draws=1_200_000,
            deep_draws=17_000_000, min_deep_keys=15_000_000, n_contigs=5,
            contig_bp=1_000_000)


def one_card(work, size=FULL):
    check_devices(1)
    data_dir = os.path.join(work, "data")
    t0 = time.time()
    db, off = write_data_dir(data_dir, size["n_src"],
                             n_funcs=size["n_funcs"])
    log(f"data dir: {len(db):,} signature kmers, max bucket "
        f"{db.max_bucket}, {len(db.functions)} functions, "
        f"{3 * len(db.functions)} families, written in "
        f"{time.time() - t0:.1f}s")
    requests = build_requests(off, 3 * len(db.functions),
                              n_prot=size["n_prot"], n_reads=size["n_reads"],
                              n_matrix_src=size["n_matrix_src"])
    from close_kmers_tpu.native.build import build
    build()                      # before kser, so only one process builds
    ref = RefThread(lambda: Reference(db, data_dir).expected(requests))
    ref.start()
    serve_subprocess(data_dir, requests, ref, work)

    tiers_phase(db, off, size["mid_draws"], size["deep_draws"],
                size["min_deep_keys"])
    famwide_phase(db, off, 2048)
    genome_phase(db, off, size["n_contigs"], size["contig_bp"])
    kernel_phase(db, off)


def four_cards(work, size=FULL):
    check_devices(4)
    data_dir = os.path.join(work, "data")
    db, off = write_data_dir(data_dir, size["n_src"],
                             n_funcs=size["n_funcs"])
    requests = build_requests(off, 3 * len(db.functions),
                              n_prot=size["n_prot"], n_reads=size["n_reads"],
                              n_matrix_src=size["n_matrix_src"])
    expected = Reference(db, data_dir).expected(requests)
    from close_kmers_tpu.native.build import build
    build()
    for label, extra in (("kser --shards 4", ["--shards", "4"]),
                         ("kser --shards 4 --routed-probe",
                          ["--shards", "4", "--routed-probe"])):
        used = serve_in_process(data_dir, requests, expected, work, extra,
                                label)
        expect(all(u > 0 for u in used[:4]),
               f"{label}: a card holds no arrays: {used}")
        gc.collect()
    spec = importlib.util.spec_from_file_location(
        "graft_entry", os.path.join(REPO, "__graft_entry__.py"))
    ge = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ge)
    t0 = time.time()
    ge.dryrun_multichip(4)
    log(f"dryrun_multichip(4) passed ({time.time() - t0:.1f}s)")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded path on four cards")
    args = ap.parse_args(argv)
    from close_kmers_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    work = os.path.join(REPO, ".smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    t0 = time.time()
    try:
        (four_cards if args.four_cards else one_card)(work)
        import jax
        devs = jax.devices()
        expect(devs[0].platform == "gpu", "device phases ran off the GPU")
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(f"all phases passed in {time.time() - t0:.1f}s")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
