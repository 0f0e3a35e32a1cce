"""A pool of gloo ranks for the port's parallel tests (not a test module).

`RankPool(world)` spawns `world` processes once, joins them into one gloo
process group on a free port and runs cases on every rank:
`pool.run(fn, *args)` calls fn(rank, world, *args) on each rank and
returns the ranks' results.  fn must be importable by name (a module-level
function, such as those of torch_parallel_cases, which imports no JAX so
that a rank starts quickly).  Each run has a deadline; when a rank fails or
the deadline passes, every rank is killed and the next run starts a new
pool, so no rank, port or hung collective outlives a case.  `close()` (the
fixtures' teardown) stops the ranks.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue
import socket
import time
import traceback


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, world, port, tasks, results, pg_timeout):
    import datetime

    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    dist.init_process_group("gloo", init_method="env://", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=pg_timeout))
    while True:
        task = tasks.get()
        if task is None:
            break
        fn, args = task
        try:
            results.put((rank, True, fn(rank, world, *args)))
        except Exception:  # report every failure to the test, then carry on
            results.put((rank, False, traceback.format_exc()))
    dist.destroy_process_group()


class RankPool:
    def __init__(self, world: int = 4, deadline: float = 60.0, pg_timeout: int = 60):
        self.world, self.deadline, self.pg_timeout = world, deadline, pg_timeout
        self._procs = []

    def start(self):
        """Spawn the ranks (they join their group in the background)."""
        ctx = mp.get_context("spawn")
        port = free_port()
        self._results = ctx.Queue()
        self._tasks = [ctx.Queue() for _ in range(self.world)]
        self._procs = [
            ctx.Process(target=_rank_main,
                        args=(r, self.world, port, self._tasks[r], self._results, self.pg_timeout),
                        daemon=True)
            for r in range(self.world)
        ]
        for p in self._procs:
            p.start()

    def run(self, fn, *args, deadline=None):
        """fn(rank, world, *args) on every rank: the results by rank."""
        if not self._procs:
            self.start()
        for q in self._tasks:
            q.put((fn, args))
        out, failed = {}, None
        end = time.monotonic() + (deadline or self.deadline)
        while len(out) < self.world and failed is None:
            try:
                rank, ok, value = self._results.get(timeout=0.5)
            except queue.Empty:
                dead = [p.exitcode for p in self._procs if p.exitcode is not None]
                if dead:
                    failed = f"a rank exited with code {dead[0]}"
                elif time.monotonic() > end:
                    failed = f"deadline of {deadline or self.deadline} s passed; ranks done: {sorted(out)}"
                continue
            if ok:
                out[rank] = value
            else:
                failed = f"rank {rank} failed:\n{value}"
        if failed is not None:
            self.close(kill=True)
            raise AssertionError(failed)
        return [out[r] for r in range(self.world)]

    def close(self, kill: bool = False):
        if not kill:
            for q in self._tasks if self._procs else ():
                q.put(None)
            for p in self._procs:
                p.join(10)
        for p in self._procs:
            if p.is_alive():
                p.kill()
            p.join(5)
        self._procs = []
