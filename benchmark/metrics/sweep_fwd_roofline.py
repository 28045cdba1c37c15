"""Share of its roofline of one compensator sweep's forward, kernel B3
(``ops/sweep.py`` ``FusedSweep``): the bound of its work
(``work.sweep_fwd``) per call over the device time of what the op
launched."""

from benchmark import work
from benchmark.trace import roofline_share


def read(run):
    count = work.sweep_fwd(run.n_nodes, run.batch,
                           int(run.cfg["hidden"][0]))
    return roofline_share(run.trace, "sweep_fwd", "FusedSweep",
                          work.bound_s(*count))
