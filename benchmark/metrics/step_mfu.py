"""The whole step's share of the card's FP32 peak: 3 × the forward
operations of every network evaluation the loss needs (forward and
backward), counted from the configuration's widths, over the time of a
step run without the profiler, in the traced run just before its trace."""

from benchmark import work


def read(run):
    if not run.plain_step_s > 0:
        return None
    flops = 3.0 * work.step_network_flops(run.wl, run.cfg, run.batch,
                                          run.n_nodes)
    return 100.0 * flops / run.plain_step_s / work.PEAK_FP32_FLOPS
