"""Profiling hooks and throughput metering.

The reference's only instrument is ``time.time()`` around the inner epoch
loop (SolversJumpDiff.py:61-67).  ``trace_profile`` captures a
``torch.profiler`` trace of a block (host activity, and the card's kernels
when there is a card) into a Chrome-trace JSON file; ``ThroughputMeter``
turns explicit windows into paths·steps/s, the unit of the JAX package's
``bench.py``.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def trace_profile(logdir: Optional[str]) -> Iterator[None]:
    """Capture a ``torch.profiler`` trace of the block into
    ``<logdir>/trace_<pid>_<ns>.json`` (open it in Perfetto or
    chrome://tracing).  CPU activity always, CUDA activity when a card is
    present.  A no-op when ``logdir`` is None, so call sites can pass the
    flag through."""
    if logdir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


class ThroughputMeter:
    """Paths·steps/s (per chip) over explicit ``mark()`` windows.

    Usage::

        meter = ThroughputMeter(paths_per_step=batch, sde_steps=model.N,
                                device="cuda")
        meter.start()
        ... run k train steps ...
        rate = meter.mark(k)["paths_steps_per_sec"]

    On a CUDA device ``start()`` and ``mark()`` wait for the device first,
    so a window measures finished work, not the enqueue."""

    def __init__(self, paths_per_step: int, sde_steps: int, n_chips: int = 1,
                 device="cpu"):
        self.paths_per_step = paths_per_step
        self.sde_steps = sde_steps
        self.n_chips = max(1, n_chips)
        self.device = torch.device(device)
        self._t0: Optional[float] = None

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self) -> None:
        self._sync()
        self._t0 = time.perf_counter()

    def mark(self, n_train_steps: int) -> dict:
        if self._t0 is None:
            raise RuntimeError("call start() first")
        self._sync()
        now = time.perf_counter()
        elapsed, self._t0 = now - self._t0, now
        work = self.paths_per_step * self.sde_steps * n_train_steps
        return {
            "elapsed_s": elapsed,
            "train_steps_per_sec": n_train_steps / elapsed,
            "paths_steps_per_sec": work / elapsed,
            "paths_steps_per_sec_per_chip": work / elapsed / self.n_chips,
        }
