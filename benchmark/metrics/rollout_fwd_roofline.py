"""Share of its roofline of the hoisted rollout's forward, kernel B1
(``ops/rollout.py`` ``FusedRollout``): the bound of its work
(``work.rollout_fwd``) per call over the device time of what the op
launched."""

from benchmark import work
from benchmark.trace import roofline_share


def read(run):
    count = work.rollout_fwd(int(run.cfg["N"]), run.batch,
                             int(run.cfg["hidden"][0]),
                             int(run.wl["solver"]["pw_pieces"]))
    return roofline_share(run.trace, "rollout_fwd", "FusedRollout",
                          work.bound_s(*count))
