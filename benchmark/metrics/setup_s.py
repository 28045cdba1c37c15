"""Seconds from the process's start to the first timed step: imports,
building or loading the kernels, the model's tables, the weights, and the
first three training steps."""


def read(run):
    if not run.setup_s == run.setup_s:
        return None
    return run.setup_s
