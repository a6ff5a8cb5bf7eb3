"""Run a function on several ranks of one machine, for tests and smoke runs
(the counterpart of the JAX package's forced host devices; a multi-GPU
deployment starts its ranks with torchrun and `init_distributed`).

    results = spawn_ranks(fn, 8, arg, backend="gloo", timeout=300)

Each rank is a process started with the `spawn` method. It limits torch to
one thread, joins a process group of `world_size` ranks through a file
rendezvous (no port to pick), calls fn(rank, *args) and sends its result
back, pickled: return numpy arrays or plain values, not device tensors. A
rank that fails makes the call raise; at the deadline every rank still
running is killed, so a hung collective cannot outlive the call.
"""

from __future__ import annotations

import multiprocessing
import os
import queue
import tempfile
import time

import torch
import torch.distributed as dist

from cspn_monodepth_tpu_torch.parallel.mesh import TIMEOUT


def _rank_main(fn, rank: int, world_size: int, init_file: str, backend: str,
               args: tuple, results) -> None:
    torch.set_num_threads(1)
    dist.init_process_group(backend, init_method=f"file://{init_file}",
                            rank=rank, world_size=world_size,
                            timeout=TIMEOUT)
    out = fn(rank, *args)
    results.put((rank, out))
    dist.destroy_process_group()


def spawn_ranks(fn, world_size: int, *args, backend: str = "gloo",
                timeout: float = 600.0, init_file: str | None = None) -> list:
    """fn(rank, *args) on `world_size` ranks; their results in rank order.
    fn must be importable by name (a module-level function). `init_file`
    is the rendezvous file, which must not exist yet (default: one in a
    fresh temporary directory). Raises RuntimeError naming the first rank
    that exits with an error, TimeoutError after `timeout` seconds."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="ranks_") as tmp:
        init_file = init_file or os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(fn, rank, world_size, init_file, backend,
                                   args, results))
                 for rank in range(world_size)]
        deadline = time.monotonic() + timeout
        out: dict[int, object] = {}
        try:
            for p in procs:
                p.start()
            # Drain the queue before joining: a rank blocks on a large
            # result until it is read.
            while len(out) < world_size:
                try:
                    rank, value = results.get(timeout=0.5)
                    out[rank] = value
                    continue
                except queue.Empty:
                    pass
                for rank, p in enumerate(procs):
                    if p.exitcode not in (None, 0):
                        raise RuntimeError(f"rank {rank} of {world_size} "
                                           f"exited with {p.exitcode}")
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{world_size} ranks still running "
                                       f"after {timeout} s")
            for rank, p in enumerate(procs):
                p.join(max(deadline - time.monotonic(), 1.0))
                if p.exitcode != 0:
                    raise RuntimeError(f"rank {rank} of {world_size} exited "
                                       f"with {p.exitcode}")
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                if p.pid is not None:
                    p.join()
    return [out[rank] for rank in range(world_size)]
