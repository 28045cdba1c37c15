"""The 90th percentile of the window's step intervals, each between the
CUDA events recorded at two step boundaries."""

from benchmark import stats


def read(run):
    if not run.step_ms:
        return None
    return stats.percentile(run.step_ms, 90)
