"""Scoring-scan kernel (ops/pallas_scan.py) parity vs the XLA scan, in
interpret mode on the CPU; the same kernel runs compiled on CUDA."""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from close_kmers_tpu.core.device_score import _scan_score, _scan_score_xla
from close_kmers_tpu.ops.pallas_scan import TB, scan_score_pallas


def random_streams(rng, B, W, n_funcs=5, p_hit=0.3):
    found = rng.random((B, W)) < p_hit
    fi = rng.integers(0, n_funcs, size=(B, W)).astype(np.int32)
    av = rng.integers(0, 300, size=(B, W)).astype(np.int32)
    wt = rng.uniform(0.1, 3.0, size=(B, W)).astype(np.float32)
    return (jnp.asarray(found), jnp.asarray(fi), jnp.asarray(av),
            jnp.asarray(wt))


def assert_same_calls(xla_out, kernel_out):
    emit_x, fields_x = xla_out
    emit_p, fields_p = kernel_out
    assert np.asarray(emit_p).shape == np.asarray(emit_x).shape
    assert np.array_equal(np.asarray(emit_x), np.asarray(emit_p))
    mask = np.asarray(emit_x)
    for fx, fp in zip(fields_x, fields_p):
        fx, fp = np.asarray(fx), np.asarray(fp)
        assert fx.dtype == fp.dtype
        # only emitted slots are meaningful
        assert np.array_equal(fx[mask], fp[mask])


@pytest.mark.parametrize("params", [
    dict(min_hits=5, min_weighted_hits=0, max_gap=200, order_constraint=0),
    dict(min_hits=2, min_weighted_hits=0, max_gap=10, order_constraint=0),
    dict(min_hits=1, min_weighted_hits=2, max_gap=50, order_constraint=0),
    dict(min_hits=2, min_weighted_hits=0, max_gap=200, order_constraint=1),
])
def test_pallas_scan_matches_xla_scan(params):
    rng = np.random.default_rng(8)
    found, fi, av, wt = random_streams(rng, 4 * TB, 96)
    assert_same_calls(
        _scan_score_xla(found, fi, av, wt, **params),
        scan_score_pallas(found, fi, av, wt, interpret=True, **params))


def test_pallas_scan_dense_runs():
    rng = np.random.default_rng(9)
    B, W = 2 * TB, 64
    # dense same-function runs: every position hits, few functions
    found = jnp.ones((B, W), bool)
    fi = jnp.asarray(rng.integers(0, 2, size=(B, W)).astype(np.int32))
    av = jnp.zeros((B, W), jnp.int32)
    wt = jnp.ones((B, W), jnp.float32)
    assert_same_calls(
        _scan_score_xla(found, fi, av, wt, 3, 0, 200, 0),
        scan_score_pallas(found, fi, av, wt, min_hits=3, interpret=True))


@pytest.mark.parametrize("B", [1, TB - 3, 3 * TB + 5])
def test_pallas_scan_pads_ragged_batch(B):
    """Batches that are not a multiple of the tile are padded with
    found=False rows inside the wrapper and sliced back."""
    rng = np.random.default_rng(B)
    found, fi, av, wt = random_streams(rng, B, 40, p_hit=0.6)
    assert_same_calls(
        _scan_score_xla(found, fi, av, wt, 2, 0, 10, 0),
        scan_score_pallas(found, fi, av, wt, min_hits=2, max_gap=10,
                          interpret=True))


def _lowered_text(platform):
    rng = np.random.default_rng(0)
    args = random_streams(rng, 2 * TB, 24)
    f = jax.jit(functools.partial(_scan_score, min_hits=5,
                                  min_weighted_hits=0, max_gap=200,
                                  order_constraint=0))
    return f.trace(*args).lower(lowering_platforms=(platform,)).as_text()


@pytest.mark.parametrize("platform,has_kernel", [("cuda", True),
                                                  ("cpu", False)])
def test_scan_choice_follows_platform(platform, has_kernel):
    """CUDA programs carry the Triton kernel (no interpret mode); every
    other platform lowers the lax.scan reference."""
    text = _lowered_text(platform)
    assert ("__gpu$xla.gpu.triton" in text) == has_kernel
    assert ("while" in text) != has_kernel


def test_dispatch_matches_reference_on_cpu():
    rng = np.random.default_rng(4)
    args = random_streams(rng, 3 * TB, 50)
    assert_same_calls(_scan_score_xla(*args, 2, 0, 20, 0),
                      _scan_score(*args, 2, 0, 20, 0))
