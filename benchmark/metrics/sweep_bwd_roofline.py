"""Share of its roofline of one sweep's adjoint, kernel B4 and its
reduction (``FusedSweepBackward``): the bound of the adjoint's own work
(``work.sweep_bwd``) per call over the device time of what the op
launched."""

from benchmark import work
from benchmark.trace import roofline_share


def read(run):
    count = work.sweep_bwd(run.n_nodes, run.batch,
                           int(run.cfg["hidden"][0]))
    return roofline_share(run.trace, "sweep_bwd", "FusedSweepBackward",
                          work.bound_s(*count))
