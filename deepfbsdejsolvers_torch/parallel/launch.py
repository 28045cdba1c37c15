"""Run a function on every rank of a world of processes on this host.

``run_ranks(fn, k, *args)`` starts k processes with the ``spawn`` method
(a parent that has initialised CUDA cannot fork), joins them into one
world through a file store in a temporary directory (no port to collide
with another run's), calls ``fn(rank, *args)`` on each and returns the
ranks' results in rank order.  A rank that raises, dies or outlives the
timeout fails the run: the others are killed and ``RuntimeError`` names
it.  ``fn`` and its arguments and results are pickled, so ``fn`` is a
module-level function and its results plain values or CPU arrays.
"""

from __future__ import annotations

import os
import queue
import tempfile
import time
import traceback
from typing import Any, Callable, List

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from deepfbsdejsolvers_torch.parallel.data_parallel import init_world


def _rank_main(fn, rank, world, init_method, device, timeout, args, out):
    try:
        if torch.device(device).type == "cpu":
            torch.set_num_threads(1)
        init_world(device, init_method=init_method, rank=rank,
                   world_size=world, timeout_s=timeout)
        result = fn(rank, *args)
        out.put((rank, True, result))
    except BaseException:
        out.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn: Callable, world_size: int, *args: Any,
              device="cuda", timeout: float = 600.0) -> List[Any]:
    """``[fn(0, *args), ..., fn(world_size − 1, *args)]``, each on a rank
    of its own (module docstring); ranks on the card share it unless the
    host has a card for each (``init_world``'s backend rule)."""
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    results, errors = {}, []
    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, world_size, init, str(device),
                                   timeout, args, out), daemon=True)
                 for r in range(world_size)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            # drain the queue before joining: a child blocks on a full pipe
            while len(results) + len(errors) < world_size:
                if time.monotonic() > deadline:
                    errors.append(f"timed out after {timeout} s with "
                                  f"{len(results)} rank(s) done")
                    break
                try:
                    rank, ok, value = out.get(timeout=1.0)
                except queue.Empty:
                    dead = [i for i, p in enumerate(procs)
                            if p.exitcode not in (None, 0)
                            and i not in results]
                    if dead:
                        errors.append(f"rank(s) {dead} died (exit codes "
                                      f"{[procs[i].exitcode for i in dead]})")
                        break
                    continue
                if ok:
                    results[rank] = value
                else:
                    errors.append(f"rank {rank} raised:\n{value}")
                    break
        finally:
            for p in procs:
                if errors:
                    p.kill()
                p.join(timeout=max(1.0, deadline - time.monotonic()))
                if p.is_alive():
                    p.kill()
                    p.join()
    bad = [i for i, p in enumerate(procs) if p.exitcode != 0]
    if errors or bad:
        raise RuntimeError(f"{world_size}-rank run of {fn.__name__} failed: "
                           + "; ".join(errors or [f"exit codes of ranks "
                                                  f"{bad}: "
                                                  f"{[procs[i].exitcode for i in bad]}"]))
    return [results[r] for r in range(world_size)]
