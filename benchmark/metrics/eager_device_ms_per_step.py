"""Device milliseconds a step of the eager layer: every device operation
that no kernel layer's op launched (noise, tables, heads, the BSDE and walk
updates, Adam)."""

from benchmark.trace import EAGER


def read(run):
    t = run.trace
    if t is None or not t.steps or EAGER not in t.layer_s:
        return None
    return 1e3 * t.layer_s[EAGER] / t.steps
