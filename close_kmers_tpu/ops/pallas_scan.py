"""The scoring state machine as one Pallas kernel for NVIDIA GPUs
(Triton route).

The run/gap/two-hit state machine (kguts.cc:734-877) is sequential along
a sequence's W window positions and independent across sequences.  The
XLA version (core/device_score._scan_score_xla) is a ``lax.scan``, which
XLA runs as a device-side loop of W dependent steps, each launching a few
small kernels over the whole batch.  This kernel runs the whole W loop
inside one launch instead: each program owns a tile of ``TB`` sequences,
one thread per sequence, keeps the 13-field machine state in registers,
reads column t of the ``[B, W]`` probe outputs at step t and writes
column t of the call-emission planes.

Semantics are those of _scan_score_xla, step for step (same masked-select
formulation, same f32 addition order); tests/test_pallas.py checks the
two against each other in interpret mode on the CPU.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..params import K

# Sequences per program and warps per program, chosen on an H100 at
# B = 4096, W = 300 (sweep in PERF.md): 256 one-warp programs spread the
# batch over all 132 SMs.
TB = 16
NUM_WARPS = 1


def _scan_kernel(found_ref, fi_ref, av_ref, wt_ref,
                 emit_ref, cs_ref, ce_ref, cc_ref, cf_ref, cw_ref,
                 *, W, min_hits, min_weighted_hits, max_gap,
                 order_constraint):
    i32 = jnp.int32
    zero = jnp.zeros((TB,), i32)
    zf = jnp.zeros((TB,), jnp.float32)
    minw = jnp.float32(min_weighted_hits)

    def flush_fields(s):
        (num_hits, current, first_pos, prev_fi, prev_pos, prev_av, prev_wt,
         prev2_fi, prev2_pos, prev2_wt, cnt, wsum, last_match) = s
        emit = (num_hits > 0) & (cnt >= min_hits) & (wsum >= minw)
        return emit, (first_pos, last_match + (K - 1), cnt, current, wsum)

    def apply_flush(s, fire):
        (num_hits, current, first_pos, prev_fi, prev_pos, prev_av, prev_wt,
         prev2_fi, prev2_pos, prev2_wt, cnt, wsum, last_match) = s
        reseed = (fire & (num_hits >= 2) & (prev2_fi != current)
                  & (prev2_fi == prev_fi))
        clear = fire & ~reseed
        return (
            jnp.where(reseed, 2, jnp.where(clear, 0, num_hits)),
            jnp.where(reseed, prev_fi, current),
            jnp.where(reseed, prev2_pos, first_pos),
            prev_fi, prev_pos, prev_av, prev_wt,
            prev2_fi, prev2_pos, prev2_wt,
            jnp.where(reseed, 2, jnp.where(clear, 0, cnt)),
            jnp.where(reseed, prev2_wt + prev_wt, jnp.where(clear, zf, wsum)),
            jnp.where(reseed, prev_pos, last_match),
        )

    def write_call(t, emit, call):
        emit_ref[:, t] = emit.astype(jnp.int8)
        cs_ref[:, t] = call[0]
        ce_ref[:, t] = call[1]
        cc_ref[:, t] = call[2]
        cf_ref[:, t] = call[3]
        cw_ref[:, t] = call[4]

    def step(t, s):
        h = found_ref[:, t] != 0
        fi = fi_ref[:, t]
        av = av_ref[:, t]
        wt = wt_ref[:, t]
        posb = jnp.full((TB,), t, i32)

        (num_hits, current, first_pos, prev_fi, prev_pos, prev_av, prev_wt,
         prev2_fi, prev2_pos, prev2_wt, cnt, wsum, last_match) = s

        # gap handling (kguts.cc:821-831)
        gap = h & (num_hits > 0) & (prev_pos + max_gap < posb)
        gf_flush = gap & (num_hits >= min_hits)
        gf_reset = gap & ~gf_flush
        emitA, callA = flush_fields(s)
        emitA = emitA & gf_flush
        s = apply_flush(s, gf_flush)
        (num_hits, current, first_pos, prev_fi, prev_pos, prev_av, prev_wt,
         prev2_fi, prev2_pos, prev2_wt, cnt, wsum, last_match) = s
        num_hits = jnp.where(gf_reset, 0, num_hits)
        cnt = jnp.where(gf_reset, 0, cnt)
        wsum = jnp.where(gf_reset, zf, wsum)

        # current_fI seeding and admission (kguts.cc:833-842)
        was0 = num_hits == 0
        cur = jnp.where(h & was0, fi, current)
        if order_constraint:
            drift = (posb - prev_pos) - (prev_av - av)
            admit = h & (was0 | ((fi == prev_fi)
                                 & (drift >= 0) & (drift <= 20)))
        else:
            admit = h

        # append (kguts.cc:844-851)
        match = fi == cur
        new_num = jnp.where(admit, num_hits + 1, num_hits)
        s = (new_num,
             cur,
             jnp.where(admit & was0, posb, first_pos),
             jnp.where(admit, fi, prev_fi),
             jnp.where(admit, posb, prev_pos),
             jnp.where(admit, av, prev_av),
             jnp.where(admit, wt, prev_wt),
             jnp.where(admit, prev_fi, prev2_fi),
             jnp.where(admit, prev_pos, prev2_pos),
             jnp.where(admit, prev_wt, prev2_wt),
             jnp.where(admit & match, cnt + 1, cnt),
             jnp.where(admit & match, wsum + wt, wsum),
             jnp.where(admit & match, posb, last_match))

        # two-in-a-row flush (kguts.cc:852-856)
        tir = admit & (new_num > 1) & (cur != fi) & (s[7] == fi)
        emitB, callB = flush_fields(s)
        emitB = emitB & tir
        s = apply_flush(s, tir)

        emit = emitA | emitB
        write_call(t, emit, tuple(jnp.where(emitA, a, b)
                                  for a, b in zip(callA, callB)))
        return s

    init = (zero, zero, zero, zero, zero, zero, zf,
            zero, zero, zf, zero, zf, zero)
    s = jax.lax.fori_loop(0, W, step, init)

    # end-of-sequence flush (kguts.cc:873-875)
    emitF, callF = flush_fields(s)
    write_call(W, emitF & (s[0] >= min_hits), callF)


@functools.partial(
    jax.jit,
    static_argnames=("min_hits", "min_weighted_hits", "max_gap",
                     "order_constraint", "interpret"))
def scan_score_pallas(found, h_fi, h_av, h_wt, min_hits=5,
                      min_weighted_hits=0, max_gap=200, order_constraint=0,
                      interpret=False):
    """Kernel-backed equivalent of device_score._scan_score_xla.

    Inputs [B, W] for any B (rows are padded to a multiple of TB with
    found=False and sliced off again).  Returns (emit [B, W+1] bool,
    fields list of [B, W+1]) like _scan_score_xla.
    """
    B, W = found.shape
    Bp = -(-B // TB) * TB
    if Bp != B:
        pad = ((0, Bp - B), (0, 0))
        found, h_fi, h_av, h_wt = (jnp.pad(a, pad)
                                   for a in (found, h_fi, h_av, h_wt))

    in_spec = pl.BlockSpec((TB, W), lambda i: (i, 0))
    out_spec = pl.BlockSpec((TB, W + 1), lambda i: (i, 0))
    # outputs vary over the same mesh axes as the inputs (shard_map)
    vma = frozenset().union(*(jax.typeof(a).vma
                              for a in (found, h_fi, h_av, h_wt)))

    def out(dtype):
        return jax.ShapeDtypeStruct((Bp, W + 1), dtype, vma=vma)

    kernel = functools.partial(
        _scan_kernel, W=W, min_hits=min_hits,
        min_weighted_hits=min_weighted_hits, max_gap=max_gap,
        order_constraint=order_constraint)
    emit, cs, ce, cc, cf, cw = pl.pallas_call(
        kernel,
        grid=(Bp // TB,),
        in_specs=[in_spec] * 4,
        out_specs=(out_spec,) * 6,
        out_shape=(out(jnp.int8), out(jnp.int32), out(jnp.int32),
                   out(jnp.int32), out(jnp.int32), out(jnp.float32)),
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name="scan_score",
    )(found.astype(jnp.int8), h_fi, h_av, h_wt)
    return emit[:B] != 0, [cs[:B], ce[:B], cc[:B], cf[:B], cw[:B]]
