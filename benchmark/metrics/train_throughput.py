"""Path-steps per second over the timed window: batch × time steps × the
steps completed, over the window's host-clock seconds, which end when the
last step issued has finished."""

from benchmark import stats


def read(run):
    if not run.steps or not run.window_s == run.window_s:
        return None
    return stats.throughput(run.batch, int(run.cfg["N"]), run.steps,
                            run.window_s)
