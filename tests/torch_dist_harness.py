"""A pool of gloo ranks on the CPU for the port's multi-rank tests.

``RankPool(world)`` spawns ``world`` processes once (a test module holds one
pool in a module-scoped fixture); each joins one gloo process group on a free
localhost port and then waits for cases. ``pool.run("case", **kwargs)`` runs
``tests/torch_dist_cases.<case>(**kwargs)`` on every rank at once and returns
the per-rank results (picklable trees of numpy arrays). A rank that raises
fails the call with its traceback; a call that does not finish within its
timeout kills the ranks and fails, so a deadlocked collective ends the test
instead of the test run. This module and the cases import no jax: the ranks
stay light.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import socket
import time
import traceback
from typing import Any, List


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _worker(rank: int, world: int, port: int, conn) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                                rank=rank, world_size=world)
        import tests.torch_dist_cases as cases

        conn.send(("ready", None))
        while True:
            msg = conn.recv()
            if msg is None:
                break
            name, kwargs = msg
            try:
                conn.send(("ok", getattr(cases, name)(**kwargs)))
            except Exception:  # noqa: BLE001 - the traceback goes to the test
                conn.send(("err", traceback.format_exc()))
    except Exception:  # noqa: BLE001
        conn.send(("err", traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


class RankPool:
    def __init__(self, world: int, start_timeout: float = 120.0):
        ctx = mp.get_context("spawn")
        self.world = world
        port = free_port()
        self._conns, self._procs = [], []
        env_threads = os.environ.get("OMP_NUM_THREADS")
        os.environ["OMP_NUM_THREADS"] = "1"
        try:
            for r in range(world):
                parent, child = ctx.Pipe()
                p = ctx.Process(target=_worker, args=(r, world, port, child), daemon=True)
                p.start()
                self._conns.append(parent)
                self._procs.append(p)
        finally:
            if env_threads is None:
                os.environ.pop("OMP_NUM_THREADS", None)
            else:
                os.environ["OMP_NUM_THREADS"] = env_threads
        self._collect("start", start_timeout)

    def _collect(self, what: str, timeout: float) -> List[Any]:
        from multiprocessing.connection import wait

        deadline = time.monotonic() + timeout
        out: List[Any] = [None] * self.world
        pending = dict(enumerate(self._conns))
        while pending:
            ready = wait(list(pending.values()), max(deadline - time.monotonic(), 0.0))
            if not ready:
                self.close(kill=True)
                raise TimeoutError(f"ranks {sorted(pending)} did not finish {what!r} "
                                   f"within {timeout} s")
            for r in [r for r, c in pending.items() if c in ready]:
                try:
                    status, value = pending.pop(r).recv()
                except EOFError:
                    status, value = "err", "the rank's process ended"
                if status == "err":
                    self.close(kill=True)
                    raise RuntimeError(f"rank {r} failed {what!r}:\n{value}")
                out[r] = value
        return out

    def run(self, case: str, timeout: float = 120.0, **kwargs) -> List[Any]:
        for conn in self._conns:
            conn.send((case, kwargs))
        return self._collect(case, timeout)

    def close(self, kill: bool = False) -> None:
        for conn, p in zip(self._conns, self._procs):
            if not kill and p.is_alive():
                try:
                    conn.send(None)
                except (BrokenPipeError, OSError):
                    pass
        for p in self._procs:
            p.join(timeout=0 if kill else 10)
            if p.is_alive():
                p.kill()
                p.join(timeout=5)
        self._procs, self._conns = [], []


class single_rank:
    """A world-size-1 gloo process group in this process, for the tests that
    build a one-rank mesh (``with single_rank(): ...``); destroyed on exit."""

    def __enter__(self):
        import torch.distributed as dist

        self._own = not dist.is_initialized()
        if self._own:
            dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{free_port()}",
                                    rank=0, world_size=1)
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist

        if self._own and dist.is_initialized():
            dist.destroy_process_group()
        return False
