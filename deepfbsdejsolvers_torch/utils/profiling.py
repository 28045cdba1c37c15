"""Profiling: the trace exporter, spans inside the training step, and the
set-up counters.

The reference's only instrument is ``time.time()`` around the inner epoch
loop (SolversJumpDiff.py:61-67).  Here:

* ``trace_profile`` captures a ``torch.profiler`` trace of a block (host
  activity, and the card's kernels when there is a card) into a
  Chrome-trace JSON file, and the spans recorded in the block beside it;
* ``span(name)`` (or the decorator ``spanned(name)``) marks a phase of the
  training step where its work happens, and ``step(name)`` the step
  itself, the parent of the rest.  A
  span holds its name, its host start and end (``perf_counter_ns``), its
  parent, the step it belongs to (the process's count of steps, the
  spans' shared identifier) and, on a CUDA device, two CUDA events
  recorded on the current stream at entry and exit.  Spans record only
  while a ``torch.profiler`` is recording, which each step decides once at
  its entry, or inside a ``spans()`` block.  Off, a span site costs one
  boolean test and returns a shared no-op; on, each span is also a
  ``record_function`` range while a profiler records, so the trace shows
  it as a ``user_annotation`` on the kernels' clock.  Events come from a
  pool: at a step's entry the spans whose events the device has passed
  (``query``, which does not wait) are read and their events reused, so
  recording never waits for the device and, after the first steps,
  creates no event; a summary waits for the rest.  The last ``CAPACITY``
  spans are kept;
* ``setup_add`` keeps the set-up counters, always on: seconds (and counts)
  of work a process does once, such as building the kernels or the first
  use of the optimizer.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import functools
import json
import os
import statistics
import time
from typing import Callable, Dict, Iterator, List, Optional

import torch

CAPACITY = 4096


class _Off:
    """The span of a site while spans are off: enters and exits, nothing
    else."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    """One span: open while its block runs, then a record in the ring."""

    __slots__ = ("rec", "name", "sid", "parent", "step", "t0", "t1", "e0",
                 "e1", "ms", "rf")

    def __init__(self, rec: "SpanRecorder", name: str):
        self.rec, self.name = rec, name
        self.e0 = self.e1 = self.ms = self.rf = None

    def __enter__(self):
        rec = self.rec
        self.sid = rec._next_id
        rec._next_id += 1
        self.parent = rec._stack[-1].sid if rec._stack else None
        self.step = rec._step
        rec._stack.append(self)
        if rec._profiler:
            self.rf = torch.autograd.profiler.record_function(self.name)
            self.rf.__enter__()
        if rec._cuda:
            self.e0 = rec._event()
            self.e0.record()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter_ns()
        rec = self.rec
        if self.e0 is not None:
            self.e1 = rec._event()
            self.e1.record()
        if self.rf is not None:
            self.rf.__exit__(*exc)
            self.rf = None
        rec._stack.pop()
        rec._keep(self)
        return False

    def stream_ms(self) -> Optional[float]:
        """Milliseconds of the current stream between the span's events
        (they must have completed), or None without a card."""
        if self.e0 is None:
            return self.ms
        return self.e0.elapsed_time(self.e1)

    def record(self) -> dict:
        return {"id": self.sid, "name": self.name, "parent": self.parent,
                "step": self.step, "host_start_ns": self.t0,
                "host_end_ns": self.t1, "stream_ms": self.stream_ms()}


class SpanRecorder:
    """The spans of a process and its set-up counters (``RECORDER``)."""

    def __init__(self, capacity: int = CAPACITY):
        self.capacity = capacity
        self.on = False           # the one test a span site makes
        self._forced = 0          # depth of spans() blocks
        self._profiler = False    # spans are record_function ranges too
        self._cuda = False        # spans record CUDA events
        self._stack: List[_Span] = []
        self._ring: collections.deque = collections.deque()
        self._pool: list = []     # free CUDA events
        self._pending: collections.deque = collections.deque()
        self._next_id = 0
        self._steps = 0           # steps entered in this process
        self._step: Optional[int] = None
        self._dropped_step = -1   # the newest step a dropped span was of
        self.setup: Dict[str, Dict[str, float]] = {}

    # ------------------------------------------------------------- recording
    def _event(self):
        return (self._pool.pop() if self._pool
                else torch.cuda.Event(enable_timing=True))

    def _keep(self, s: _Span) -> None:
        if len(self._ring) >= self.capacity:
            old = self._ring.popleft()
            if old.step is not None:
                self._dropped_step = max(self._dropped_step, old.step)
        self._ring.append(s)
        if s.e0 is not None:
            self._pending.append(s)

    def _resolve(self, wait: bool = False) -> None:
        """Read the stream time of each closed span whose end event has
        completed (of every one, waiting for it, with ``wait``) and return
        its events to the pool.  The end events complete in the order the
        spans closed, so the first one still running ends the pass."""
        pending = self._pending
        while pending:
            s = pending[0]
            if wait:
                s.e1.synchronize()
            elif not s.e1.query():
                break
            s.ms = s.e0.elapsed_time(s.e1)
            self._pool += [s.e0, s.e1]
            s.e0 = s.e1 = None
            pending.popleft()

    @contextlib.contextmanager
    def _step_block(self, name: str) -> Iterator[None]:
        prev_on, prev_step = self.on, self._step
        self.on = True
        self._step = self._steps - 1
        try:
            with _Span(self, name):
                yield
        finally:
            self.on, self._step = prev_on, prev_step

    def step(self, name: str):
        """The span of one training step, the parent of the spans inside
        it: entering counts the step, and decides whether spans record
        during it (a profiler recording, or a ``spans()`` block)."""
        self._steps += 1
        profiler = torch.autograd._profiler_enabled()
        if not (self._forced or profiler):
            return _OFF
        self._profiler, self._cuda = profiler, torch.cuda.is_initialized()
        self._resolve()
        return self._step_block(name)

    @contextlib.contextmanager
    def spans(self) -> Iterator["SpanRecorder"]:
        """Spans record inside the block, with or without a profiler."""
        prev = self.on
        self._forced += 1
        self.on = True
        self._profiler = torch.autograd._profiler_enabled()
        self._cuda = torch.cuda.is_initialized()
        try:
            yield self
        finally:
            self._forced -= 1
            self.on = prev

    def mark(self) -> int:
        """The id the next span will take: pass it as ``since`` to read
        only the spans recorded after this call."""
        return self._next_id

    # --------------------------------------------------------------- reading
    def _kept(self, since: int) -> List[_Span]:
        """The kept spans from id ``since``, their stream times read."""
        self._resolve(wait=True)
        return [s for s in self._ring if s.sid >= since]

    def records(self, since: int = 0) -> List[dict]:
        """The kept spans (from id ``since``) as dicts, oldest first."""
        return [s.record() for s in self._kept(since)]

    def summary(self, since: int = 0) -> dict:
        """{"steps": steps recorded whole, "spans": {name: {"calls",
        "host_ms", "stream_ms", "self_host_ms", "self_stream_ms"}}}: per
        span name the median over those steps of its calls, its host and
        stream milliseconds, and its self time (the span's time less what
        its child spans cover), all per step; the stream numbers None
        without a card.  Spans outside a step are left out."""
        kept = self._kept(since)
        cuda = any(s.stream_ms() is not None for s in kept)
        own = {s.sid: ((s.t1 - s.t0) * 1e-6, s.stream_ms() or 0.0)
               for s in kept}
        covered = collections.defaultdict(lambda: [0.0, 0.0])
        for s in kept:
            if s.parent is not None:
                covered[s.parent][0] += own[s.sid][0]
                covered[s.parent][1] += own[s.sid][1]
        per_step: Dict[int, Dict[str, List[float]]] = {}
        for s in kept:
            if s.step is None or s.step <= self._dropped_step:
                continue
            host, stream = own[s.sid]
            row = per_step.setdefault(s.step, {}).setdefault(s.name,
                                                             [0.0] * 5)
            for k, v in enumerate((1.0, host, stream,
                                   host - covered[s.sid][0],
                                   stream - covered[s.sid][1])):
                row[k] += v
        names = sorted({n for by in per_step.values() for n in by})
        out = {}
        for name in names:
            rows = [by.get(name, [0.0] * 5) for by in per_step.values()]
            med = [statistics.median(r[k] for r in rows) for k in range(5)]
            out[name] = {"calls": med[0], "host_ms": med[1],
                         "stream_ms": med[2] if cuda else None,
                         "self_host_ms": med[3],
                         "self_stream_ms": med[4] if cuda else None}
        return {"steps": len(per_step), "spans": out}

    # ------------------------------------------------------ set-up counters
    def setup_add(self, name: str, seconds: float, **counts: float) -> None:
        """Add ``seconds`` and each count to set-up counter ``name``."""
        c = self.setup.setdefault(name, {"seconds": 0.0})
        c["seconds"] += seconds
        for key, v in counts.items():
            c[key] = c.get(key, 0) + v


RECORDER = SpanRecorder()


def span(name: str):
    """``with span("fbsde.noise"): ...``: a span of the process's
    recorder, or the shared no-op while spans are off."""
    return _Span(RECORDER, name) if RECORDER.on else _OFF


def spanned(name: str) -> Callable:
    """Decorator: each call of the function is a span of ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if not RECORDER.on:
                return fn(*args, **kwargs)
            with _Span(RECORDER, name):
                return fn(*args, **kwargs)

        return inner

    return wrap


def step(name: str):
    """``with step("fbsde.step"): ...``: one training step's span."""
    return RECORDER.step(name)


def spans():
    """``with spans(): ...``: spans record inside the block."""
    return RECORDER.spans()


def span_summary(since: int = 0) -> dict:
    """``SpanRecorder.summary`` of the process's recorder."""
    return RECORDER.summary(since)


def setup_add(name: str, seconds: float, **counts: float) -> None:
    """``SpanRecorder.setup_add`` on the process's recorder."""
    RECORDER.setup_add(name, seconds, **counts)


def setup_counters() -> Dict[str, Dict[str, float]]:
    """A copy of the process's set-up counters: {name: {"seconds", ...}}."""
    return copy.deepcopy(RECORDER.setup)


@contextlib.contextmanager
def trace_profile(logdir: Optional[str]) -> Iterator[None]:
    """Capture a ``torch.profiler`` trace of the block into
    ``<logdir>/trace_<pid>_<ns>.json`` (open it in Perfetto or
    chrome://tracing), and the spans its steps recorded (the profiler
    turns them on) into ``<logdir>/spans_<pid>_<ns>.json``: {"summary":
    ``span_summary``, "spans": the spans, oldest first}.  CPU activity
    always, CUDA activity when a card is present.  A no-op when ``logdir``
    is None, so call sites can pass the flag through."""
    if logdir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    since = RECORDER.mark()
    with profile(activities=activities) as prof:
        yield
    stamp = f"{os.getpid()}_{time.time_ns()}"
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{stamp}.json"))
    with open(os.path.join(logdir, f"spans_{stamp}.json"), "w") as f:
        json.dump({"summary": RECORDER.summary(since),
                   "spans": RECORDER.records(since)}, f)
