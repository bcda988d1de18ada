"""(Re)record the golden conversation snapshots in tests/golden/.

Starts the server on tests/golden/data, plays every conversation from
tests/test_golden.py CONVS, and writes the raw response bytes to
tests/golden/<name>.resp.  Run ONLY when a semantic change is intended —
the snapshots are the byte-level behavior lock.

Usage: JAX_PLATFORMS=cpu python scripts/record_golden.py [name ...]
"""

from __future__ import annotations

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))


def main():
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import asyncio
    import threading

    from close_kmers_tpu.cli.kser import load_server_context
    from close_kmers_tpu.server.http import handle_connection
    from test_golden import CONVS, GOLDEN, http, play

    which = set(sys.argv[1:]) or set(CONVS)
    ctx = load_server_context(os.path.join(GOLDEN, "data"), batch_size=64)
    loop = asyncio.new_event_loop()
    holder = {}
    ready = threading.Event()

    async def run():
        srv = await asyncio.start_server(
            lambda r, w: handle_connection(r, w, ctx), "127.0.0.1", 0)
        holder["port"] = srv.sockets[0].getsockname()[1]
        ready.set()
        async with srv:
            await ctx.stop_event.wait()

    t = threading.Thread(target=lambda: loop.run_until_complete(run()),
                         daemon=True)
    t.start()
    assert ready.wait(60)

    with open(os.path.join(GOLDEN, "queries.fa"), "rb") as f:
        body = f.read()
    # Conversations run in the same (sorted) order the test uses, so
    # stateful ones (named-universe /add) see identical server state.
    for name in sorted(CONVS):
        resp = play(holder["port"], CONVS[name](body))
        if name in which:
            with open(os.path.join(GOLDEN, f"{name}.resp"), "wb") as f:
                f.write(resp)
            print(f"recorded {name}: {len(resp)} bytes")
    ctx.stop_event.set()


if __name__ == "__main__":
    main()
