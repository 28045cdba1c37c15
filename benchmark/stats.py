"""The window's arithmetic: throughput and a step percentile."""

from __future__ import annotations

from typing import Sequence


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile (0 < q < 100) of ``values`` by linear
    interpolation between order statistics (``statistics.quantiles``'
    inclusive method); a single value is its own percentile."""
    vals = sorted(float(v) for v in values)
    if not vals:
        raise ValueError("percentile of no values")
    if len(vals) == 1:
        return vals[0]
    pos = (len(vals) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(vals) - 1)
    return vals[lo] + (vals[hi] - vals[lo]) * (pos - lo)


def throughput(batch: int, steps_per_path: int, n_steps: int,
               seconds: float) -> float:
    """Path-steps per second: ``n_steps`` training steps of ``batch`` paths
    over ``steps_per_path`` time steps each, in ``seconds``."""
    if seconds <= 0:
        raise ValueError(f"a window of {seconds} s")
    return batch * steps_per_path * n_steps / seconds

