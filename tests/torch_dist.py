"""Gloo process groups for the port's multi-process CPU tests, under a
watchdog.

`DistPool(world)` spawns `world` processes that join one gloo process group
and then run tasks: `pool.run("module:function", *args)` calls the function
on every rank with `(rank, world, *args)` and returns the per-rank results
in rank order. Arguments and results are numpy arrays and plain Python
values; the functions live in `torch_dist_workers.py`, which imports torch
and never JAX. A task that raises on any rank, or outlasts its timeout
(120 s), kills every process and fails with the ranks' output, so a rank
stuck in a mismatched collective fails one test instead of hanging the
suite. A pool serves one test module (`pools` fixture): process start-up
and the group's rendezvous are paid once.
"""

from __future__ import annotations

import importlib
import os
import queue
import socket
import sys
import tempfile
import time
import traceback
from datetime import timedelta

import multiprocessing as mp

TASK_TIMEOUT = 120.0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _worker_main(rank, world, port, tasks, results, log_path, sys_path):
    fd = os.open(log_path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC)
    os.dup2(fd, 1)
    os.dup2(fd, 2)
    sys.path[:0] = [p for p in sys_path if p not in sys.path]
    for var in ("SPN4CIR_DISTRIBUTED", "SPN4CIR_DIST_COORDINATOR",
                "SPN4CIR_DIST_NPROCS", "SPN4CIR_DIST_PROC_ID"):
        os.environ.pop(var, None)
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank,
                            timeout=timedelta(seconds=TASK_TIMEOUT))
    while True:
        task = tasks.get()
        if task is None:
            break
        name, args = task
        try:
            mod, fn = name.split(":")
            out = getattr(importlib.import_module(mod), fn)(rank, world,
                                                            *args)
            results.put((rank, True, out))
        except BaseException:  # report it; the parent kills the pool
            results.put((rank, False, traceback.format_exc()))
        sys.stdout.flush()
    dist.destroy_process_group()


class DistPool:
    def __init__(self, world: int):
        ctx = mp.get_context("spawn")
        self.world = world
        self.logdir = tempfile.mkdtemp(prefix="torch_dist_")
        self.results = ctx.Queue()
        self.tasks = [ctx.Queue() for _ in range(world)]
        port = _free_port()
        here = os.path.dirname(os.path.abspath(__file__))
        sys_path = [here, os.path.dirname(here)]
        self.procs = [ctx.Process(
            target=_worker_main,
            args=(r, world, port, self.tasks[r], self.results,
                  os.path.join(self.logdir, f"rank{r}.log"), sys_path),
            daemon=True) for r in range(world)]
        for p in self.procs:
            p.start()
        self.broken = False

    def _logs(self) -> str:
        out = []
        for r in range(self.world):
            path = os.path.join(self.logdir, f"rank{r}.log")
            try:
                with open(path) as f:
                    text = f.read()[-4000:]
            except OSError:
                text = "(no output)"
            out.append(f"--- rank {r} ---\n{text}")
        return "\n".join(out)

    def kill(self) -> None:
        self.broken = True
        for p in self.procs:
            if p.is_alive():
                p.kill()
        for p in self.procs:
            p.join(5)

    def run(self, name: str, *args, timeout: float = TASK_TIMEOUT):
        if self.broken:
            raise RuntimeError("the process pool was killed by an earlier "
                               "failure")
        for q in self.tasks:
            q.put((name, args))
        out = [None] * self.world
        deadline = time.monotonic() + timeout
        for _ in range(self.world):
            try:
                rank, ok, value = self.results.get(
                    timeout=max(deadline - time.monotonic(), 0.1))
            except queue.Empty:
                dead = [r for r, p in enumerate(self.procs)
                        if not p.is_alive()]
                self.kill()
                raise AssertionError(
                    f"{name}: no result within {timeout:.0f} s (dead ranks "
                    f"{dead}); every rank killed\n{self._logs()}")
            if not ok:
                self.kill()
                raise AssertionError(f"{name} failed on rank {rank}:\n"
                                     f"{value}\n{self._logs()}")
            out[rank] = value
        return out

    def close(self) -> None:
        if not self.broken:
            for q in self.tasks:
                q.put(None)
            for p in self.procs:
                p.join(10)
        self.kill()


class Pools:
    """One `DistPool` per world size, made at first use; `close` ends all.
    A pool killed by a failure is made again for the next test."""

    def __init__(self):
        self._pools = {}

    def __call__(self, world: int) -> DistPool:
        pool = self._pools.get(world)
        if pool is None or pool.broken:
            pool = self._pools[world] = DistPool(world)
        return pool

    def close(self) -> None:
        for pool in self._pools.values():
            pool.close()
        self._pools.clear()

