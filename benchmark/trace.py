"""Reading the profiler's trace of the traced window.

The trace is ``torch.profiler``'s Chrome trace.  Each device operation (a
kernel, a copy or a fill) carries the ``External id`` of the CPU op that
launched it; failing that, its ``correlation`` names the runtime call,
whose thread and time find the CPU ops that enclose it.  A device
operation belongs to the layer (``layers/<name>.json``) one of whose op
names is among the ops enclosing its launch, and to the eager layer
otherwise.  The port's CUDA kernels are told apart by their namespaces
(``rollout::``, ``rollout_wide::``, ``sweep::``, ``sweep_wide::``,
``icdf::``), but a name does not say which autograd op a launch served:
the launching op does, so a layer is found by it and not by the name.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
EAGER = "eager"


def load_layers(folder: Path) -> Dict[str, List[str]]:
    """{layer: [op names]} from ``folder``/<layer>.json files, each a JSON
    object with the key ``ops``."""
    layers = {}
    for path in sorted(Path(folder).glob("*.json")):
        layers[path.stem] = list(json.loads(path.read_text())["ops"])
    return layers


class _Thread:
    """The CPU ops of one thread as a nesting tree, for "which ops enclose
    time t" queries."""

    def __init__(self, ops):
        ops = sorted(ops, key=lambda e: (e["ts"], -e["dur"]))
        self.starts = [e["ts"] for e in ops]
        self.ops = ops
        self.parent: List[int] = []
        stack: List[int] = []
        for i, e in enumerate(ops):
            while stack and not (e["ts"] < self._end(stack[-1])
                                 and e["ts"] >= ops[stack[-1]]["ts"]):
                stack.pop()
            self.parent.append(stack[-1] if stack else -1)
            stack.append(i)

    def _end(self, i):
        e = self.ops[i]
        return e["ts"] + e["dur"]

    def enclosing(self, t: float) -> List[str]:
        """Names of the ops that contain ``t``, innermost first."""
        i = bisect.bisect_right(self.starts, t) - 1
        names = []
        while i >= 0:
            if self.ops[i]["ts"] <= t <= self._end(i):
                names.append(self.ops[i]["name"])
            i = self.parent[i]
        return names


@dataclasses.dataclass
class TraceSummary:
    """What the readers of per-layer metrics read from a traced window."""

    steps: int
    window_s: float
    busy_s: float
    layer_s: Dict[str, float]
    layer_ops: Dict[str, int]
    op_calls: Dict[str, int]
    device_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]
    n_device_ops: int


def short_name(name: str, width: int = 160) -> str:
    """A device operation's name without its trailing argument list (the
    last top-level parenthesis group, when the name ends with one), cut to
    ``width`` characters."""
    if name.endswith(")"):
        depth = 0
        for k in range(len(name) - 1, 0, -1):
            depth += {")": 1, "(": -1}.get(name[k], 0)
            if depth == 0:
                if name[k - 1] not in " <,":
                    name = name[:k]
                break
    return name[:width]


def _union(intervals: Sequence[Tuple[float, float]]):
    """Sorted disjoint union of (start, end) intervals."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarize(events: list, layers: Dict[str, List[str]], steps: int,
              window_s: float, top: int = 10) -> TraceSummary:
    """Attribute each device operation of ``events`` (a Chrome trace's
    ``traceEvents``) to a layer, and sum the device's busy time, the
    layers' device seconds and operation counts, the calls of each layer's
    ops, the ``top`` device operations by time, and the ``top`` longest
    idle gaps, each named by the innermost CPU op of the deepest nest of
    ops running at its middle on any thread."""
    by_ext: Dict[int, dict] = {}
    runtime: Dict[int, dict] = {}
    cpu_by_tid: Dict[object, list] = {}
    device = []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        args = e.get("args") or {}
        if cat in ("cpu_op", "user_annotation"):
            cpu_by_tid.setdefault(e.get("tid"), []).append(e)
            if cat == "cpu_op" and "External id" in args:
                by_ext.setdefault(args["External id"], e)
        elif cat in ("cuda_runtime", "cuda_driver"):
            if "correlation" in args:
                runtime[args["correlation"]] = e
        elif cat in DEVICE_CATS:
            device.append(e)
    threads = {tid: _Thread(ops) for tid, ops in cpu_by_tid.items()}
    op_layer = {op: layer for layer, ops in layers.items() for op in ops}

    def chain(ev) -> List[str]:
        args = ev.get("args") or {}
        launch = runtime.get(args.get("correlation"))
        if launch is not None and launch.get("tid") in threads:
            return threads[launch["tid"]].enclosing(launch["ts"])
        op = by_ext.get(args.get("External id"))
        if op is not None:
            return threads[op["tid"]].enclosing(op["ts"] + 1e-3)
        return []

    layer_s: Dict[str, float] = {}
    layer_ops: Dict[str, int] = {}
    by_name: Dict[str, float] = {}
    spans = []
    for ev in device:
        names = chain(ev)
        layer = next((op_layer[n] for n in names if n in op_layer), EAGER)
        dur = ev["dur"] * 1e-6
        layer_s[layer] = layer_s.get(layer, 0.0) + dur
        layer_ops[layer] = layer_ops.get(layer, 0) + 1
        key = short_name(ev["name"])
        by_name[key] = by_name.get(key, 0.0) + dur
        spans.append((ev["ts"], ev["ts"] + ev["dur"]))
    busy = _union(spans)
    op_calls = {}
    for ops in cpu_by_tid.values():
        for e in ops:
            if e["name"] in op_layer:
                op_calls[e["name"]] = op_calls.get(e["name"], 0) + 1
    gaps = []
    for (_, end), (start, _) in zip(busy[:-1], busy[1:]):
        mid = 0.5 * (end + start)
        chains = [t.enclosing(mid) for t in threads.values()]
        names = max(chains, key=len) if chains else []
        gaps.append((names[0] if names else "(no host op)",
                     (start - end) * 1e-6))
    return TraceSummary(
        steps=steps, window_s=window_s,
        busy_s=sum(e - s for s, e in busy) * 1e-6,
        layer_s=layer_s, layer_ops=layer_ops, op_calls=op_calls,
        device_ops=sorted(by_name.items(), key=lambda kv: -kv[1])[:top],
        idle_gaps=sorted(gaps, key=lambda kv: -kv[1])[:top],
        n_device_ops=len(device))


def roofline_share(summary: Optional[TraceSummary], layer: str, op: str,
                   bound_s: float) -> Optional[float]:
    """A layer's share of its roofline in percent: ``bound_s`` (the least
    time of one call of ``op``) times the calls the trace saw, over the
    device seconds attributed to ``layer``; None where the trace holds
    neither."""
    if summary is None:
        return None
    seconds = summary.layer_s.get(layer, 0.0)
    calls = summary.op_calls.get(op, 0)
    if seconds <= 0.0 or calls == 0:
        return None
    return 100.0 * calls * bound_s / seconds
