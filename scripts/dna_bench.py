"""Whole-genome contig benchmark: the sparse-hit DNA workload
(BASELINE config analogue: genome FASTA -> 6-frame calls).

Synthesizes a genome by concatenating reverse-translated source
proteins (so a fraction of windows are true signature hits) with random
intergenic DNA, then runs the full process_seq-parity path: 6-frame
translation, long-contig halo tiling, device probe, native scoring.
Reports bases/s and the window hit rate — the sparse regime the serving
bench's dense protein corpus does not exercise.

Reuses bench.py's corpus/DB cache.  Usage:
  [BENCH_* env, DNA_MBP=5] python scripts/dna_bench.py
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench  # noqa: E402

MBP = float(os.environ.get("DNA_MBP", 5))

# one codon per amino acid (table 11), index = aa offset 0..19
CODON = ["GCG", "TGC", "GAT", "GAA", "TTT", "GGT", "CAT", "ATT", "AAA",
         "CTG", "ATG", "AAC", "CCG", "CAG", "CGT", "AGC", "ACC", "GTT",
         "TGG", "TAT"]


def synth_genome(rng, src_off: np.ndarray, n_bases: int) -> str:
    """Alternate reverse-translated source proteins with random DNA."""
    parts = []
    total = 0
    i = 0
    bases = np.array(list("ACGT"))
    while total < n_bases:
        if i % 2 == 0:
            prot = src_off[rng.integers(0, len(src_off))]
            dna = "".join(CODON[o] for o in prot)
        else:
            dna = "".join(rng.choice(bases, size=900))
        parts.append(dna)
        total += len(dna)
        i += 1
    return "".join(parts)[:n_bases]


def main():
    import jax
    from close_kmers_tpu.core.api import KmerEngine
    from close_kmers_tpu.core.dna import probe_long_sequence
    from close_kmers_tpu.native import api as native
    from close_kmers_tpu.ops.translate import six_frame_kguts_offsets
    from close_kmers_tpu.params import EngineParams

    from close_kmers_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()

    rng = np.random.default_rng(0)
    db, offsets, _lengths = bench.build_corpus(rng)
    eng = KmerEngine(db)
    n_bases = int(MBP * 1e6)
    t0 = time.time()
    genome = synth_genome(rng, offsets[:, :bench.PROT_LEN], n_bases)
    print(f"genome: {len(genome):,} bp in {time.time()-t0:.1f}s",
          file=sys.stderr)
    params = EngineParams()

    def one_pass():
        t0 = time.time()
        n_calls = n_hits = n_windows = 0
        frames = six_frame_kguts_offsets(genome)  # digit-space translate
        t_tr = time.time() - t0
        for _strand, _off, prot in frames:
            h = probe_long_sequence(eng, prot, want_code=False,
                                    want_oi=False, want_avg=False)
            nc, *_rest = native.score_batch(
                h["pos"], h["fi"], h["oi"], h["avg_off"], h["wt"],
                h["row_off"], params, max_calls_per_seq=65536,
                want_votes=False)
            n_calls += int(nc.sum())
            n_hits += len(h["pos"])
            n_windows += max(0, len(prot) - 8)
        dt = time.time() - t0
        return dt, t_tr, n_calls, n_hits, n_windows

    one_pass()  # compile + warm
    best = None
    for p in range(3):
        dt, t_tr, n_calls, n_hits, n_windows = one_pass()
        print(f"pass {p}: {len(genome)/dt/1e6:.2f} Mbp/s "
              f"({dt:.2f}s, translate {t_tr:.2f}s, {n_calls} calls, "
              f"hit rate {n_hits/max(1,n_windows):.3%})", file=sys.stderr)
        best = min(best or dt, dt)
    print(f"best: {len(genome)/best/1e6:.2f} Mbp/s on "
          f"{len(genome):,} bp", file=sys.stderr)


if __name__ == "__main__":
    main()
