"""FASTQ read benchmark: reads/s through the /fq_lookup compute path
(BASELINE config 3 analogue: FASTQ -> 6-frame ORFs > 10 aa -> best
family match per ORF -> best frame per read).

Synthesizes reads by reverse-translating windows of the bench corpus's
source proteins (coding strand, so one frame carries real signature
runs) plus a fraction of random reads, then drives the same pipeline as
server._process_reads minus the HTTP layer: get_possible_proteins per
read, one batched annotate_family over all ORFs, best-frame selection.

Reuses bench.py's corpus/DB cache.  Usage:
  [BENCH_* env, FQ_READS=20000 FQ_LEN=150] python scripts/fq_bench.py
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench  # noqa: E402
from dna_bench import CODON  # noqa: E402

N_READS = int(os.environ.get("FQ_READS", 20_000))
READ_LEN = int(os.environ.get("FQ_LEN", 150))


def synth_reads(rng, src_off: np.ndarray, n_reads: int, read_len: int):
    """~70% coding reads (a random window of a reverse-translated source
    protein, random strand/offset), ~30% random DNA."""
    bases = np.array(list("ACGT"))
    comp = str.maketrans("ACGT", "TGCA")
    reads = []
    for i in range(n_reads):
        if rng.random() < 0.7:
            prot = src_off[rng.integers(0, len(src_off))]
            dna = "".join(CODON[o] for o in prot)
            start = int(rng.integers(0, max(1, len(dna) - read_len)))
            r = dna[start:start + read_len]
            if rng.random() < 0.5:
                r = r.translate(comp)[::-1]
        else:
            r = "".join(rng.choice(bases, size=read_len))
        reads.append((f"read{i}", r))
    return reads


def main():
    import jax
    from close_kmers_tpu.core.api import KmerEngine
    from close_kmers_tpu.db.family_db import KmerFamilyMapping
    from close_kmers_tpu.ops.translate import batch_orf_arrays
    from close_kmers_tpu.params import EngineParams

    from close_kmers_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()

    from close_kmers_tpu.db.family_db import FamilyData
    from close_kmers_tpu.db.signature_db import SignatureDB

    rng = np.random.default_rng(0)
    db, offsets, lengths = bench.build_corpus(rng)
    # real function names so best-call -> family function matching works
    n_funcs = int(db.fi.max()) + 1
    db = SignatureDB(db.keys, db.fi, db.oi, db.avg_off, db.wt,
                     functions=[f"fn{i}" for i in range(n_funcs)])

    # synthetic family universe, same shape as bench.bench_family but
    # with metadata: fam id f belongs to function fn{f//3}, genus f%5
    n = len(db)
    deg = rng.integers(1, 4, size=n)
    offs = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(deg, out=offs[1:])
    vals = np.repeat(db.fi * 3, deg) + (np.arange(offs[-1]) % 3).astype(np.int32)
    mapping = KmerFamilyMapping()
    mapping._fam_csr = (db.keys, offs, vals.astype(np.int32))
    mapping.families = [
        FamilyData(f"PGF_{f:08d}", f"PLF_{f % 5}_{f:08d}", f % 5,
                   f"fn{f // 3}", f, 10, 10)
        for f in range(3 * n_funcs)]

    eng = KmerEngine(db)
    params = EngineParams()
    t0 = time.time()
    reads = synth_reads(rng, offsets[:2048, :bench.PROT_LEN], N_READS,
                        READ_LEN)
    print(f"reads: {len(reads)} x {READ_LEN} bp in {time.time()-t0:.1f}s",
          file=sys.stderr)

    def one_pass():
        # the serving path: array-native ORF batcher -> padded fused
        # family pass -> (read x frame) reduction (server/http.py
        # _process_reads)
        t0 = time.time()
        ofs, lens, toks = batch_orf_arrays([seq for _, seq in reads])
        t_orf = time.time() - t0
        matches = eng.best_family_matches_padded(
            ofs, lens, mapping, params, kmer_hit_threshold=3,
            genus_filter=False, as_arrays=True)
        scores = np.where(matches.gfam_score > 0, matches.score,
                          0.0).astype(np.float64)
        tok_score = np.where(toks["orf"] >= 0, scores[toks["orf"]], 0.0)
        totals = np.zeros((len(reads), 6), dtype=np.float64)
        np.add.at(totals, (toks["read"], toks["fpos"].astype(np.int64)),
                  tok_score)
        n_called = int((totals.max(axis=1) > 0).sum())
        dt = time.time() - t0
        return dt, t_orf, ofs.shape[0], n_called

    one_pass()  # compile + warm
    best_dt = None
    for p in range(3):
        dt, t_orf, n_orfs, n_called = one_pass()
        print(f"pass {p}: {N_READS/dt:.0f} reads/s ({dt:.2f}s, orf-split "
              f"{t_orf:.2f}s, {n_orfs} ORFs, {n_called} reads called)",
              file=sys.stderr)
        if best_dt is None or dt < best_dt:
            best_dt = dt
    print(f"best: {N_READS/best_dt:.0f} reads/s "
          f"({N_READS * READ_LEN / best_dt / 1e6:.2f} Mbp/s)",
          file=sys.stderr)


if __name__ == "__main__":
    main()
