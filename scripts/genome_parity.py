"""Cross-check the device-resident genome path (core/genome.py) against
the prior host-scored path (core/dna.probe_long_sequence + native
score_batch) on the full bench genome, frame by frame, call by call.

Both claim process_seq parity; bench.py recorded 2793 calls (old) vs
2787 (new) on the same 5 Mbp input, so one of them diverges.  This
script prints the first differing frame and the differing call tuples.

Usage: python scripts/genome_parity.py [mbp]
"""

from __future__ import annotations

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench  # noqa: E402


def main():
    import jax

    from close_kmers_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()

    from dna_bench import synth_genome  # noqa: F401
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scripts"))
    from dna_bench import synth_genome
    from close_kmers_tpu.core.api import KmerEngine
    from close_kmers_tpu.core.dna import probe_long_sequence
    from close_kmers_tpu.core.genome import GenomeAnnotator
    from close_kmers_tpu.native import api as native
    from close_kmers_tpu.ops.translate import six_frame_kguts_offsets
    from close_kmers_tpu.params import EngineParams

    mbp = float(sys.argv[1]) if len(sys.argv) > 1 else 5.0
    rng = np.random.default_rng(0)
    db, offsets, _lengths = bench.build_corpus(rng)
    eng = KmerEngine(db)
    rng4 = np.random.default_rng(4)
    genome = synth_genome(rng4, offsets[:, :bench.PROT_LEN],
                          int(mbp * 1e6))
    params = EngineParams()

    # old path: per-frame host-scored calls
    old_frames = []
    for _strand, _off, prot in six_frame_kguts_offsets(genome):
        h = probe_long_sequence(eng, prot, want_code=False,
                                want_oi=False, want_avg=False)
        nc, cs, ce, cc, cf, cw = native.score_batch(
            h["pos"], h["fi"], h["oi"], h["avg_off"], h["wt"],
            h["row_off"], params, max_calls_per_seq=65536,
            want_votes=False)[:6]
        calls = []
        for r in range(len(nc)):
            for i in range(int(nc[r])):
                calls.append((int(cs[r, i]), int(ce[r, i]), int(cc[r, i]),
                              int(cf[r, i]), np.float32(cw[r, i])))
        old_frames.append(calls)

    ga = GenomeAnnotator(eng)
    per_frame, new_frames = ga.calls_of(genome, params)

    n_old = sum(len(f) for f in old_frames)
    n_new = int(per_frame.sum())
    print(f"old {n_old} calls, new {n_new} calls")
    for f in range(6):
        a, b = old_frames[f], new_frames[f]
        if len(a) != len(b):
            print(f"frame {f}: old {len(a)} vs new {len(b)} calls")
        sa, sb = set(map(tuple, a)), set(map(tuple, b))
        for c in sorted(sa - sb)[:10]:
            print(f"  frame {f} only-old: {c}")
        for c in sorted(sb - sa)[:10]:
            print(f"  frame {f} only-new: {c}")
        for i, (x, y) in enumerate(zip(a, b)):
            if tuple(x) != tuple(y):
                print(f"  frame {f} first order-diff at {i}: {x} vs {y}")
                break


if __name__ == "__main__":
    main()
