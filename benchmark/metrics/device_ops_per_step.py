"""Device operations (kernels, copies, fills) a step of the eager layer, a
count: with the host issuing each, it is what sets a host-bound step."""

from benchmark.trace import EAGER


def read(run):
    t = run.trace
    if t is None or not t.steps or EAGER not in t.layer_ops:
        return None
    return t.layer_ops[EAGER] / t.steps
