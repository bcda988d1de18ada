"""chip_smoke.py and the platform rules it checks.

On the CPU: the script refuses to run without a GPU, its request
generators and host reference agree with the server at a small size, the
compile-cache helper, and that no kernel targets another accelerator.
The ``gpu`` test runs the whole script on a card (``python -m pytest
tests/test_chip_smoke.py -m gpu`` on a GPU machine)."""

import asyncio
import importlib.util
import os
import pathlib
import shutil
import subprocess
import sys
import threading

import jax
import numpy as np
import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402
from close_kmers_tpu.core import oracle as O  # noqa: E402
from close_kmers_tpu.ops.encoder import seq_to_offsets  # noqa: E402


def _clean_env(**extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS",
                        "JAX_COMPILATION_CACHE_DIR")}
    env.update(extra)
    return env


def _run_smoke(cwd, script):
    return subprocess.run([sys.executable, str(script)], cwd=cwd,
                          capture_output=True, text=True, timeout=600,
                          env=_clean_env(JAX_PLATFORMS="cpu"))


def test_chip_smoke_fails_without_gpu():
    p = _run_smoke(REPO, REPO / "chip_smoke.py")
    assert p.returncode != 0
    assert '"ok"' not in p.stdout
    assert "no GPU" in p.stderr


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    p = _run_smoke(tmp_path, tmp_path / "chip_smoke.py")
    assert p.returncode != 0
    assert '"ok"' not in p.stdout


@pytest.fixture
def gpu():
    """Skip unless JAX outside this CPU-pinned test process finds a GPU."""
    p = subprocess.run(
        [sys.executable, "-c",
         "import jax; print(jax.devices()[0].platform)"],
        capture_output=True, text=True, timeout=300, env=_clean_env())
    if p.returncode or p.stdout.strip().splitlines()[-1:] != ["gpu"]:
        pytest.skip("no GPU visible to JAX")


@pytest.mark.gpu
def test_chip_smoke_on_gpu(gpu):
    p = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                       cwd=REPO, capture_output=True, text=True,
                       timeout=1500, env=_clean_env())
    assert p.returncode == 0, p.stderr[-5000:]
    assert p.stdout.strip().splitlines()[-1].startswith('{"ok": true')


# -- the smoke's own reference, at a small size ----------------------------

SMALL = dict(n_src=600, n_funcs=150)


@pytest.fixture(scope="module")
def small_service(tmp_path_factory):
    """A small smoke data dir served in-process, its requests and their
    reference answers."""
    from close_kmers_tpu.cli.kser import load_server_context
    from close_kmers_tpu.server.http import handle_connection

    d = str(tmp_path_factory.mktemp("smoke") / "data")
    db, off = cs.write_data_dir(d, **SMALL)
    requests = cs.build_requests(off, 3 * SMALL["n_funcs"], n_prot=60,
                                 n_reads=60, n_matrix_src=10)
    expected = cs.Reference(db, d).expected(requests)
    ctx = load_server_context(d, batch_size=32)
    ctx.engine.device_family_min = 0      # the fused family program too
    loop = asyncio.new_event_loop()
    ready = threading.Event()
    port = {}

    async def run():
        srv = await asyncio.start_server(
            lambda r, w: handle_connection(r, w, ctx), "127.0.0.1", 0)
        port["p"] = srv.sockets[0].getsockname()[1]
        ready.set()
        async with srv:
            await ctx.stop_event.wait()

    threading.Thread(target=lambda: loop.run_until_complete(run()),
                     daemon=True).start()
    assert ready.wait(60)
    # /matrix needs the /add before it: answer in request order
    got = {name: cs.post(port["p"], path, body)
           for name, path, body, _ in requests}
    yield got, expected
    ctx.stop_event.set()


@pytest.mark.parametrize("name", ["query", "lookup_best", "fq_lookup",
                                  "add", "matrix"])
def test_reference_matches_server(small_service, name):
    got, expected = small_service
    assert got[name] == expected[name]
    if name != "add":
        assert got[name].count("\n") > 10


def test_oracle_scan_matches_oracle():
    """window_hits + GatherState replay == gather_hits' own scan."""
    rng = np.random.default_rng(5)
    from close_kmers_tpu.db.signature_db import SignatureDB
    seqs = ["".join(rng.choice(list("ACDEFGHIKLMNPQRSTVWYX"), size=n))
            for n in rng.integers(5, 200, size=40)]
    seqs += ["ACDEFGHIKL" * 12]
    codes = [int(c) for s in seqs
             for c in cs.window_hits(_all_db(seqs), seq_to_offsets(s))[1]]
    keys = np.unique(np.array(codes[::2], dtype=np.int64))
    db = SignatureDB(keys, rng.integers(0, 3, len(keys)),
                     rng.integers(-1, 4, len(keys)),
                     rng.integers(0, 300, len(keys)),
                     rng.uniform(0.1, 2, len(keys)).astype(np.float32))
    for s in seqs:
        calls, hits, otu = [], [], O.OtuStats()
        O.process_aa_seq(s, db.lookup, cs.PARAMS, calls, hits.append, otu)
        c2, h2, o2 = cs.oracle_scan(db, seq_to_offsets(s))
        assert (c2, h2) == (calls, hits)
        assert o2.otus_by_count == otu.otus_by_count


def _all_db(seqs):
    """A DB holding every valid window of ``seqs``."""
    from close_kmers_tpu.db.signature_db import SignatureDB
    codes = []
    for s in seqs:
        o = seq_to_offsets(s).astype(np.int64)
        for p in range(len(o) - cs.K + 1):
            w = o[p:p + cs.K]
            if w.max() < 20:
                codes.append(int(w @ cs.POW))
    keys = np.unique(np.array(codes, dtype=np.int64))
    z = np.zeros(len(keys), np.int32)
    return SignatureDB(keys, z, z, z, z.astype(np.float32))


# -- platform rules ---------------------------------------------------------

@pytest.mark.parametrize("env_dir", [None, "custom_cache"])
def test_compile_cache_location(tmp_path, env_dir):
    code = ("import jax; from close_kmers_tpu.utils.compile_cache import "
            "enable_compile_cache as e; print(e()); "
            "print(jax.config.jax_compilation_cache_dir)")
    extra = {"PYTHONPATH": str(REPO)}
    if env_dir:
        extra["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / env_dir)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=tmp_path,
                       env=_clean_env(JAX_PLATFORMS="cpu", **extra))
    assert p.returncode == 0, p.stderr
    used, configured = p.stdout.split()
    want = str(tmp_path / env_dir) if env_dir else str(REPO / ".jax_cache")
    assert used == configured == want


def test_no_kernels_for_another_accelerator():
    other = "t" "pu"     # the Pallas backend of the first target
    banned = (f"pallas.{other}", f"pallas import {other}", f"pl{other}")
    files = [p for d in ("close_kmers_tpu", "scripts", "tests")
             for p in (REPO / d).rglob("*.py")]
    files += [REPO / "bench.py", REPO / "chip_smoke.py"]
    offenders = [str(p) for p in files
                 if any(b in p.read_text() for b in banned)]
    assert offenders == []


def test_dryrun_multichip_raises_with_too_few_devices():
    spec = importlib.util.spec_from_file_location(
        "graft_entry_smoke", REPO / "__graft_entry__.py")
    g = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(g)
    with pytest.raises(RuntimeError, match="needs"):
        g.dryrun_multichip(len(jax.devices()) + 1)


def test_device_memory_bytes():
    from close_kmers_tpu.core.engine import device_memory_bytes
    assert device_memory_bytes(jax.devices("cpu")[0]) > (1 << 30)

    class NoLimit:
        platform = "gpu"

        def memory_stats(self):
            return {}

    with pytest.raises(RuntimeError, match="no memory limit"):
        device_memory_bytes(NoLimit())
