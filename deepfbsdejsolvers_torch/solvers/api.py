"""Reference-parity solver classes.

One class per scheme, ``SolverGlobalFBSDE(math_model, lrate, ...)
.train(batchSize, batchSizeVal, num_epoch, num_epochExt) -> (listY0,
duration)``, the surface of the reference's solver classes, over the
functional core in :mod:`deepfbsdejsolvers_torch.solvers.pricing`;
``SOLVER_CLASSES`` maps the reference's method names to them.  Two
configurations of note:

* the reference-faithful parity configuration, e.g.
  ``SolverGlobalFBSDE(make_merton_default(), lrate, sweep_impl="pallas")``:
  exact Poisson jumps, the per-path series price, and every step the Γ head
  swept over the 49-node quadrature (or, with
  ``CompensatorSpec(kind="mc")``, 5000 fresh Monte-Carlo nodes) at every
  path, on the card by the CUDA kernels B3/B4 for the schemes with a Γ net
  (global, multistep2, sumlocal2);
* the speed configuration, hoisted piecewise tables
  (``hoist=True, hoist_interp="piecewise"``, a collocated model and
  compensator), for the global scheme with ``fused_rollout=True`` the CUDA
  kernels B1/B2.
"""

from __future__ import annotations

from typing import Optional, Tuple

from deepfbsdejsolvers_torch.ops.compensator import CompensatorSpec
from deepfbsdejsolvers_torch.solvers.pricing import PricingSolver
from deepfbsdejsolvers_torch.solvers.train import (
    TrainResult, fit, make_generator)


class _SolverFacade:
    scheme: str = ""

    def __init__(self, math_model, lrate: float, hidden=(21, 21),
                 activation: str = "tanh",
                 compensator: CompensatorSpec = CompensatorSpec(),
                 seed: int = 0, **solver_kw):
        """``solver_kw`` passes through to :class:`PricingSolver`, e.g.
        ``hoist=True``, ``fused_rollout=True`` and ``device`` ("cuda" by
        default; the CPU only when asked for with ``device="cpu"``)."""
        self.core = PricingSolver(
            model=math_model, scheme=self.scheme, hidden=tuple(hidden),
            activation=activation, compensator=compensator, **solver_kw,
        )
        self.math_model = math_model
        self.lrate = lrate
        self.seed = seed
        self.listY0: list = []
        self.lossList: list = []
        self.duration: float = 0.0
        self.durationList: list = []
        self.params = None
        self.result: Optional[TrainResult] = None

    def train(self, batch_size: int, batch_size_val: int, num_epoch: int,
              num_epoch_ext: int, verbose: bool = True) -> Tuple[list, float]:
        params = self.core.init_params(make_generator("cpu", self.seed, 0))
        res = fit(
            loss_fn=self.core.build_loss(batch_size),
            params=params,
            seed=self.seed,
            lrate=self.lrate,
            num_epoch=num_epoch,
            num_epoch_ext=num_epoch_ext,
            val_loss_fn=self.core.build_loss(batch_size_val),
            y0_fn=self.core.y0_estimate,
            verbose=verbose,
        )
        self.result = res
        self.params = res.params
        self.listY0 = res.y0_history
        self.lossList = res.loss_history
        self.duration = res.duration
        self.durationList = res.duration_history
        return res.y0_history, res.duration


class SolverGlobalFBSDE(_SolverFacade):
    """Trainable-Y0 global deep-BSDE."""
    scheme = "global"


class SolverMultiStepFBSDE1(_SolverFacade):
    """One-net multistep forward replication."""
    scheme = "multistep1"


class SolverMultiStepFBSDE2(_SolverFacade):
    """Two-net multistep forward replication."""
    scheme = "multistep2"


class SolverSumLocalFBSDE1(_SolverFacade):
    """One-net one-step residual scheme."""
    scheme = "sumlocal1"


class SolverSumLocalFBSDE2(_SolverFacade):
    """Two-net one-step residual scheme."""
    scheme = "sumlocal2"


class SolverGlobalSumLocalReg(_SolverFacade):
    """Y-only local regression.  The reference trains it with 1000× the
    nominal batch; pass the batch you want, there is no hidden
    multiplier."""
    scheme = "sumlocal_reg"


class SolverGlobalMultiStepReg(_SolverFacade):
    """Y-only multistep regression."""
    scheme = "multistep_reg"


SOLVER_CLASSES = {
    "Global": SolverGlobalFBSDE,
    "SumMultiStep1": SolverMultiStepFBSDE1,
    "SumMultiStep2": SolverMultiStepFBSDE2,
    "SumLocal1": SolverSumLocalFBSDE1,
    "SumLocal2": SolverSumLocalFBSDE2,
    "SumLocalReg": SolverGlobalSumLocalReg,
    "SumMultiStepReg": SolverGlobalMultiStepReg,
}
