"""Share of its roofline of the rollout's adjoint, kernel B2 and its
reduction (``FusedRolloutBackward``): the bound of the adjoint's own work
(``work.rollout_bwd``) per call over the device time of what the op
launched."""

from benchmark import work
from benchmark.trace import roofline_share


def read(run):
    count = work.rollout_bwd(int(run.cfg["N"]), run.batch,
                             int(run.cfg["hidden"][0]),
                             int(run.wl["solver"]["pw_pieces"]))
    return roofline_share(run.trace, "rollout_bwd", "FusedRolloutBackward",
                          work.bound_s(*count))
