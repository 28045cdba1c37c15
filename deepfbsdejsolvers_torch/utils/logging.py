"""Structured metrics logging: an append-only JSON-lines stream per
experiment, one record per outer epoch or event, re-readable by
``read_jsonl``.  The reference's only observability is a per-epoch print of
loss, seconds and Y0 (SolversJumpDiff.py:70, MFGSolvers.py:89)."""

from __future__ import annotations

import json
import os
import time
from typing import IO, Any, Dict, Optional

import numpy as np
import torch


def _jsonable(v: Any) -> Any:
    """Tensors and numpy scalars or arrays, also inside tuples and lists,
    as JSON types."""
    if isinstance(v, (tuple, list)):
        return [_jsonable(x) for x in v]
    if torch.is_tensor(v):
        v = v.detach().cpu()
        return v.item() if v.ndim == 0 else v.tolist()
    if isinstance(v, (np.ndarray, np.generic)):
        return v.tolist()
    return v


class JSONLWriter:
    """Append-only JSON-lines writer; each record flushed at once, so a
    crashed run still leaves a readable log."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._fh: Optional[IO[str]] = open(path, "a")

    def write(self, record: Dict[str, Any]) -> None:
        if self._fh is None:
            raise ValueError("writer is closed")
        self._fh.write(json.dumps({k: _jsonable(v)
                                   for k, v in record.items()}) + "\n")
        self._fh.flush()

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self) -> "JSONLWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class MetricsLogger:
    """Per-epoch metrics sink: an optional JSONL file and an optional echo
    to stdout; every record carries the logger's tags and the seconds since
    it started.  Under ``mesh`` (``parallel/data_parallel.py``) rank 0
    alone writes and echoes, so that each record appears once."""

    def __init__(self, path: Optional[str] = None,
                 tags: Optional[Dict[str, Any]] = None, echo: bool = False,
                 mesh=None):
        if mesh is not None and mesh.rank != 0:
            path, echo = None, False
        self._writer = JSONLWriter(path) if path else None
        self._tags = dict(tags or {})
        self._echo = echo
        self._t0 = time.time()

    def log(self, **metrics: Any) -> None:
        record = {**self._tags, "wall_s": round(time.time() - self._t0, 3),
                  **metrics}
        if self._writer is not None:
            self._writer.write(record)
        if self._echo:
            print(" ".join(f"{k}={_jsonable(v)}" for k, v in record.items()))

    def child(self, **extra_tags: Any) -> "MetricsLogger":
        """A logger sharing this one's file, with more fixed tags."""
        c = MetricsLogger.__new__(MetricsLogger)
        c._writer = self._writer
        c._tags = {**self._tags, **extra_tags}
        c._echo = self._echo
        c._t0 = self._t0
        return c

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()


def read_jsonl(path: str) -> list:
    """A JSONL metrics file as a list of dicts."""
    out = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out
