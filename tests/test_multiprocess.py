"""Real multi-process jax.distributed execution.

Spawns 2 coordinator+worker processes on localhost (CPU backend, 4
virtual devices each -> an 8-device global ("data", "table") mesh), runs
the sharded probe step across processes, and has every process verify
its addressable output shards against the single-chip engine — the same
step a real pod would run with table shards on ICI and DP across hosts.
"""

import os
import socket
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "scripts", "multiproc_worker.py")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_procs(nproc: int, extra=(), timeout=420):
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("JAX_PLATFORMS", None)   # worker sets its own
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, str(i), str(nproc), str(port),
             *extra],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for i in range(nproc)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outs.append(out.decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {i} failed:\n{out}"
    return outs


@pytest.mark.slow
def test_two_process_full_step_matches_single_process():
    """Probe AND the full annotate step (scores + family rollup + psum)
    across 2 real processes, on shallow- and deep-bucket DB shapes."""
    outs = _run_procs(2)
    for i, out in enumerate(outs):
        assert f"proc {i} [shallow/wide]: OK" in out, out
        assert f"proc {i} [deep/sub]: OK" in out, out
        assert f"proc {i}: OK" in out, out


@pytest.mark.slow
def test_four_process_full_step_matches_single_process():
    """Same checks over 4 processes x 2 local devices."""
    os.environ["MP_LOCAL_DEVICES"] = "2"
    try:
        outs = _run_procs(4, timeout=600)
    finally:
        os.environ.pop("MP_LOCAL_DEVICES", None)
    for i, out in enumerate(outs):
        assert f"proc {i} [shallow/wide]: OK" in out, out
        assert f"proc {i} [deep/sub]: OK" in out, out


@pytest.mark.slow
def test_two_process_bench_reports_throughput():
    outs = _run_procs(2, extra=("--bench",))
    for i, out in enumerate(outs):
        assert "seqs/s/process" in out, out


@pytest.mark.slow
def test_two_process_midsize_real_slice():
    """Cross-process parity over a REAL mid-size DB (>= 10M keys sliced
    from the 208M scale build when its artifact exists, else an
    equivalently-shaped synthetic DB), with uneven hi-space occupancy —
    probe, full annotate step, AND the routed serving step."""
    scale = "/root/scale/scale_db.npz"
    src = scale if os.path.exists(scale) else "synth"
    outs = _run_procs(2, extra=("--midsize", src), timeout=1200)
    for i, out in enumerate(outs):
        assert f"proc {i} [midsize/" in out, out
        assert f"proc {i}: OK" in out, out
