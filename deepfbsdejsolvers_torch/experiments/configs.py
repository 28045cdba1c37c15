"""Typed experiment configs with the reference's defaults:

* Merton: mainMerton.py:13-23 (nbNeuron=21, nbLayer=2, nEpochExt=120,
  nEpoch=100, batchSize=10, lRateY0=4e-4, lRateLoc=3e-4, lRateReg=3e-4,
  aLin=0.1, limit=30);
* VG: mainVG.py:12-22 (lRateY0=5e-4, lRateLoc=3e-4, lRateReg=1.5e-4);
* MFG comparison: mainMFGComparison.py:13-31 (nbNeuron_hat=20, nbNeuron=22,
  nEpochExt=100, nEpoch=200, batchSize=128, jumpFac=2.16, nbDays=2,
  lRateY0=1e-3, lRateLoc=1.5e-4, lRateReg=1e-4);
* MFG PoA: mainMFGPoA.py:18-36 (nEpoch=300, batchSize=64, jumpFac=12,
  nbDays=1, lRateY0=1e-2, lRateLoc=1e-3, lRateReg=5e-3).

``data_parallel=True`` shards each method's path batch over the ranks of
the launcher's world (``python -m torch.distributed.run``; a world of one
without a launcher; ``parallel/data_parallel.py``), rank 0 alone writing
under ``io.outdir``.  ``compute_dtype="bfloat16"`` runs the heads'
matmuls in bf16 (the pipeline then sweeps in plain PyTorch, as the kernels
compute in f32); ``scan_chunk`` chunks the solvers' time loops
(``ops/scan.py``).
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Dict, Optional, Sequence, Tuple

PRICING_METHODS = ("Global", "SumMultiStep1", "SumMultiStep2", "SumLocal1",
                   "SumLocal2", "SumLocalReg", "SumMultiStepReg")
# Reference method name -> scheme key of solvers/pricing.py.
PRICING_METHOD_TO_SCHEME = {
    "Global": "global",
    "SumMultiStep1": "multistep1",
    "SumMultiStep2": "multistep2",
    "SumLocal1": "sumlocal1",
    "SumLocal2": "sumlocal2",
    "SumLocalReg": "sumlocal_reg",
    "SumMultiStepReg": "multistep_reg",
}
MFG_METHODS = ("Global", "SumMultiStep", "SumLocal", "SumLocalReg",
               "SumMultiStepReg")

# Reference method name -> scheme key of solvers/mfg.py.
MFG_METHOD_TO_SCHEME = {
    "Global": "global",
    "SumMultiStep": "multistep",
    "SumLocal": "sumlocal",
    "SumLocalReg": "sumlocal_reg",
    "SumMultiStepReg": "multistep_reg",
}

@dataclasses.dataclass
class RunIO:
    """Where (and whether) to write artifacts.  The pricing pipeline
    checkpoints and resumes; the MFG pipelines, as the JAX package's, take
    ``checkpoint_every`` and ``resume``, write no checkpoint and say so
    on stderr."""

    outdir: Optional[str] = None      # None -> no files written
    metrics_jsonl: bool = True        # write <outdir>/metrics.jsonl
    save_plots: bool = False          # write figures (needs matplotlib)
    checkpoint_every: int = 0         # epochs between checkpoints (0 = off)
    resume: bool = False              # resume from the latest checkpoint
    profile_dir: Optional[str] = None  # torch.profiler trace directory

    def warn_no_checkpoint(self, pipeline: str) -> None:
        """Say on stderr that ``pipeline`` (one that writes and restores no
        checkpoint) ignores ``checkpoint_every`` and ``resume``."""
        asked = [f for f, on in (("checkpoint_every", self.checkpoint_every),
                                 ("resume", self.resume)) if on]
        if asked:
            print(f"{pipeline}: {' and '.join(asked)} asked for; this "
                  "pipeline writes and restores no checkpoint, so it trains "
                  "from scratch", file=sys.stderr)


@dataclasses.dataclass
class PricingConfigBase:
    """Shared knobs of the two pricing experiments (the JAX package's
    fields and defaults, so that a configuration carries across)."""

    nb_neuron: int = 21
    nb_layer: int = 2
    n_epoch_ext: int = 120
    n_epoch: int = 100
    batch_size: int = 10
    lrate_y0: float = 4e-4
    lrate_loc: float = 3e-4
    lrate_reg: float = 3e-4
    activation: str = "tanh"
    a_lin: float = 0.1
    methods: Sequence[str] = PRICING_METHODS
    compensator: str = "quadrature"   # "quadrature" | "mc" (reference: mc)
    n_mc: int = 5000
    n_poisson_max: int = 6            # quadrature sizing (Merton)
    n_hermite: int = 8
    n_laguerre: int = 12              # quadrature sizing (VG)
    compute_dtype: Optional[str] = None   # "bfloat16": bf16 head matmuls
    # "pallas" sweeps the Γ head by the CUDA kernels B3/B4 where the
    # method's head takes them (experiments/pricing.py chooses per method)
    sweep_impl: str = "xla"
    jump_sampler: str = "exact"       # "icdf" = truncated inverse-CDF sampler
    x_interp: str = "direct"          # "chebyshev" = collocated compensator
    n_cheb: int = 64
    # Hoist the collocation tables out of the time loop (the speed path;
    # requires x_interp="chebyshev")
    hoist: bool = False
    hoist_interp: str = "piecewise"   # "clenshaw" | "piecewise"
    scan_chunk: int = 0               # chunked time loop (ops/scan.py)
    price_mode: str = "series"        # "chebyshev" = collocated pricer
    # The reference trains the two Y-only regression schemes on 1000x the
    # nominal batch inside the solver (SolversJumpDiff.py:435,503), kept as
    # an explicit knob instead of a hidden multiplier.
    reg_batch_multiplier: int = 1000
    # Shard the path batch over the ranks of the launcher's world (a data
    # mesh; each rank takes its per_shard_batch of the batches)
    data_parallel: bool = False
    # Report Y0 as the mean of the last k outer-epoch read-outs (1 = the
    # reference's last one).
    y0_tail_avg: int = 1
    # Start the global scheme's trainable Y0 at an oracle-free Monte-Carlo
    # payoff estimate instead of a unit-normal draw; off by default.
    y0_warm_start: bool = False
    seed: int = 0
    io: RunIO = dataclasses.field(default_factory=RunIO)

    @property
    def hidden(self) -> Tuple[int, ...]:
        return (self.nb_neuron,) * self.nb_layer

    def lrate_for(self, method: str) -> float:
        """Per-method learning rate (mainMerton.py:105-118)."""
        if method == "Global":
            return self.lrate_y0
        if method in ("SumLocalReg", "SumMultiStepReg"):
            return self.lrate_reg
        return self.lrate_loc


@dataclasses.dataclass
class MertonConfig(PricingConfigBase):
    """mainMerton.py defaults (:13-23, params :57)."""

    limit: int = 30


@dataclasses.dataclass
class VGConfig(PricingConfigBase):
    """mainVG.py defaults (:12-22, params :54)."""

    lrate_y0: float = 5e-4
    lrate_loc: float = 3e-4
    lrate_reg: float = 1.5e-4
    pricer: str = "fft"               # "fft" | "invfourier"


@dataclasses.dataclass
class MFGConfigBase:
    nb_neuron_hat: int = 20
    nb_neuron: int = 22
    nb_layer_hat: int = 2
    nb_layer: int = 2
    n_epoch_ext: int = 100
    n_epoch: int = 200
    batch_size: int = 128
    raf_coef: int = 1
    jump_factor: float = 2.16
    nb_days: int = 2
    lrate_y0: float = 1e-3
    lrate_loc: float = 1.5e-4
    lrate_reg: float = 1e-4
    couplage: str = "ON"
    jump_model: str = "stochastic"
    activation_hat: str = "tanh"
    activation: str = "tanh"
    # "icdf" inverts the per-path Cox CDF instead of torch.poisson
    jump_sampler: str = "exact"
    scan_chunk: int = 0               # chunked time loop (ops/scan.py)
    # Shard the path batch over the ranks of the launcher's world (a data
    # mesh; each rank takes its per_shard_batch of the batches)
    data_parallel: bool = False
    # Start the global scheme's (Y0_hat, Y0) at the Picard Monte-Carlo
    # estimate (MFGSolver.warm_start_y0) instead of unit-normal draws; off
    # by default, as in the reference.
    y0_warm_start: bool = False
    seed: int = 0
    io: RunIO = dataclasses.field(default_factory=RunIO)

    @property
    def hidden_hat(self) -> Tuple[int, ...]:
        return (self.nb_neuron_hat,) * self.nb_layer_hat

    @property
    def hidden(self) -> Tuple[int, ...]:
        return (self.nb_neuron,) * self.nb_layer


@dataclasses.dataclass
class MFGComparisonConfig(MFGConfigBase):
    """mainMFGComparison.py defaults (:13-31; price coefficients :108)."""

    methods: Sequence[str] = MFG_METHODS
    # Frozen-noise evaluation paths: every trained policy is replayed on
    # one common frozen noise set and its objective cost ± 95% CI reported
    # (0 = skip).  The reference parses nbSimulation and never uses it
    # (mainMFGComparison.py:28,41); this is its intended role.
    n_simulation: int = 10**5
    pi: float = 0.1
    p0: float = 6.159423723
    p1: float = 87.4286117
    f0: float = 0.0
    f1: float = 1e4

    def lrate_for(self, method: str) -> float:
        """Per-method learning rate, the reference's crossed mapping kept:
        SumMultiStep trains with lRateReg and SumLocalReg with lRateLoc
        (mainMFGComparison.py:128-135)."""
        table = {
            "Global": self.lrate_y0,
            "SumMultiStep": self.lrate_reg,
            "SumLocal": self.lrate_loc,
            "SumMultiStepReg": self.lrate_reg,
            "SumLocalReg": self.lrate_loc,
        }
        return table[method]


@dataclasses.dataclass
class MFGPoAConfig(MFGConfigBase):
    """mainMFGPoA.py defaults (:18-36) and its case sweep (:189-198)."""

    nb_neuron: int = 20
    n_epoch_ext: int = 100
    n_epoch: int = 300
    batch_size: int = 64
    jump_factor: float = 12.0
    nb_days: int = 1
    lrate_y0: float = 1e-2
    lrate_loc: float = 1e-3
    lrate_reg: float = 5e-3
    method: str = "Global"
    n_frozen: int = 1000              # frozen-noise trajectory count
    n_replay: int = 5                 # paths recorded in the figures
    pi_list: Sequence[float] = (0.0, 0.1, 0.5, 0.95)
    # case name -> (p0, p1, f0, f1), mainMFGPoA.py:189
    cases: Dict[str, Tuple[float, float, float, float]] = dataclasses.field(
        default_factory=lambda: {
            "with jumps and with dynamic pricing":
                (6.159423723, 87.4286117, 0.0, 1e4),
            "with jumps and without pricing": (0.0, 0.0, 0.0, 1e4),
            "without jumps and with pricing":
                (6.159423723, 87.4286117, 0.0, 0.0),
        })

    def lrate_for(self, method: str) -> float:
        """mainMFGPoA.py:216-225 (no crossed mapping here)."""
        table = {
            "Global": self.lrate_y0,
            "SumMultiStep": self.lrate_loc,
            "SumLocal": self.lrate_loc,
            "SumMultiStepReg": self.lrate_reg,
            "SumLocalReg": self.lrate_reg,
        }
        return table[method]
