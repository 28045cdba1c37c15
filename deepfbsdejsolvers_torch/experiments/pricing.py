"""Pricing experiment pipeline: the mainMerton.py / mainVG.py equivalent.

Runs the method sweep (the seven deep-BSDE schemes) on one pricing model,
tracks Y0 against the model's closed-form or FFT price, and under
``config.io`` writes ``metrics.jsonl``, checkpoints (and resumes from
them), a ``torch.profiler`` trace, and the convergence figure the
reference shows interactively (mainMerton.py:124-128, mainVG.py:114-121;
matplotlib, imported only then).  Runs on the card unless
``device="cpu"`` is asked for.

The sweep is chosen per method before training: with
``sweep_impl="pallas"`` a method whose swept head the kernels B3/B4 do not
take (the jump-diffusion 2-output U-net of SumMultiStep1/SumLocal1, an
activation other than tanh, a width above 128) trains on the plain sweep,
which the pipeline prints and records as ``sweep_impl`` on every one of
that method's ``metrics.jsonl`` records.  The JAX package's solver does
the same with a warning; the port's ``PricingSolver`` itself refuses such
a head.

With ``config.data_parallel`` every method trains data-parallel over the
ranks of the launcher's world (``parallel/data_parallel.py``), each rank
rolling out its ``per_shard_batch`` of the training and validation
batches; rank 0 alone writes under ``io.outdir`` (records, checkpoints,
figure), and the other ranks wait at a barrier.
"""

from __future__ import annotations

import dataclasses
import os
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from deepfbsdejsolvers_torch.experiments.configs import (
    PRICING_METHOD_TO_SCHEME, MertonConfig, VGConfig)
from deepfbsdejsolvers_torch.models.merton import (
    MertonJumpModel, abs_coupling)
from deepfbsdejsolvers_torch.models.variance_gamma import VGModel
from deepfbsdejsolvers_torch.nets.mlp import param_leaves
from deepfbsdejsolvers_torch.ops.compensator import CompensatorSpec
from deepfbsdejsolvers_torch.parallel.data_parallel import (
    optional_mesh, per_shard_batch)
from deepfbsdejsolvers_torch.solvers.pricing import PricingSolver
from deepfbsdejsolvers_torch.solvers.train import fit, make_generator
from deepfbsdejsolvers_torch.utils.checkpointing import CheckpointManager
from deepfbsdejsolvers_torch.utils.logging import MetricsLogger
from deepfbsdejsolvers_torch.utils.profiling import trace_profile


def build_model(config):
    """The model of ``config`` (parameters: mainMerton.py:57,
    mainVG.py:54)."""
    coupling = abs_coupling(config.a_lin)
    if isinstance(config, MertonConfig):
        return MertonJumpModel(T=1.0, N=50, r=0.1, muJ=0.0, sigJ=0.2,
                               sigma=0.3, lam=3.0, K=0.9, x0=1.0,
                               coupling=coupling, limit=config.limit,
                               jump_sampler=config.jump_sampler,
                               price_mode=config.price_mode)
    if isinstance(config, VGConfig):
        # the VG model collocates its price through price_eval
        return VGModel(T=1.0, N=30, r=0.1, theta=-0.1, kappa=0.1, sigJ=0.2,
                       K=1.0, x0=1.0, coupling=coupling, pricer=config.pricer,
                       jump_sampler=config.jump_sampler,
                       price_eval=("chebyshev"
                                   if config.price_mode == "chebyshev"
                                   else "direct"))
    raise TypeError(f"unknown pricing config type {type(config).__name__}")


@dataclasses.dataclass
class MethodResult:
    method: str
    y0_history: list
    loss_history: list
    duration: float
    y0: float
    abs_error: float
    params: dict
    sweep_impl: str = "xla"       # the sweep the method trained on


@dataclasses.dataclass
class PricingRunResult:
    reference_price: float
    methods: Dict[str, MethodResult]

    def best(self) -> MethodResult:
        return min(self.methods.values(), key=lambda m: m.abs_error)


def build_solver(config, model, method: str, device: str = "cuda"
                 ) -> Tuple[PricingSolver, List[str]]:
    """The solver of ``method`` from the fields of ``config`` (as the JAX
    package's pipeline builds it), on ``device``, and why the kernel sweep
    does not apply when ``config.sweep_impl`` asks for it and the method's
    head does not fit (the solver then sweeps in plain PyTorch; an empty
    list otherwise)."""
    solver = PricingSolver(
        model=model, scheme=PRICING_METHOD_TO_SCHEME[method],
        hidden=config.hidden, activation=config.activation,
        compensator=CompensatorSpec(
            kind=config.compensator, n_mc=config.n_mc,
            n_poisson_max=config.n_poisson_max, n_hermite=config.n_hermite,
            n_laguerre=config.n_laguerre, x_interp=config.x_interp,
            n_cheb=config.n_cheb),
        compute_dtype=config.compute_dtype, sweep_impl="xla",
        hoist=config.hoist, hoist_interp=config.hoist_interp,
        scan_chunk=config.scan_chunk, device=device)
    if config.sweep_impl != "pallas":
        return solver, []
    unmet = solver.sweep_unmet()
    if unmet:
        return solver, unmet
    return dataclasses.replace(solver, sweep_impl="pallas"), []


def _y0_readout(history: list, tail: int) -> float:
    if not history:
        return float("nan")
    if tail > 1:
        return float(np.mean(history[-tail:]))
    return history[-1]


def _train_one(config, model, method: str, logger: Optional[MetricsLogger],
               verbose: bool, device: str = "cuda",
               mesh=None) -> MethodResult:
    solver, unmet = build_solver(config, model, method, device)
    if unmet and (mesh is None or mesh.rank == 0):
        print(f"  {method}: sweep_impl 'pallas' asked for; the kernels do "
              f"not take this head ({'; '.join(unmet)}), so it trains on "
              "the plain sweep (sweep_impl 'xla')", file=sys.stderr)
    if logger is not None:
        logger = logger.child(sweep_impl=solver.sweep_impl)
        logger.log(event="sweep_choice", asked=config.sweep_impl,
                   reasons=unmet)
    seed, scheme = config.seed, solver.scheme
    params = solver.init_params(make_generator("cpu", seed, 0))

    io = config.io
    mgr = None
    start_epoch, optimizer_state = 0, None
    if io.outdir and io.checkpoint_every:
        mgr = CheckpointManager(os.path.join(io.outdir, "ckpt", method),
                                mesh=mesh)
        # on the CPU: load_state_dict moves the optimizer's moments to the
        # params' device and keeps its step counts where Adam wants them
        restored = mgr.restore_latest(map_location="cpu") if io.resume \
            else None
        if restored is not None:
            step, state = restored
            if state["seed"] != seed:
                raise ValueError(f"checkpoint of seed {state['seed']} under "
                                 f"{mgr.root}, the run's seed is {seed}")
            with torch.no_grad():
                for dst, src in zip(param_leaves(params), state["params"]):
                    dst.copy_(src)
            optimizer_state = state["optimizer"]
            start_epoch = step + 1
            if verbose:
                print(f"  resumed {method} from epoch {step}")
    if start_epoch == 0 and config.y0_warm_start and scheme == "global":
        params = solver.warm_start_y0(params,
                                      make_generator(device, seed, 2))

    def on_epoch(i, metrics, state):
        if logger is not None:
            logger.log(epoch=i, **metrics)
        if mgr is not None and (i + 1) % io.checkpoint_every == 0:
            p, optimizer, s = state
            mgr.save(i, {"params": [t.detach() for t in param_leaves(p)],
                         "optimizer": optimizer.state_dict(), "seed": s,
                         "epoch": i})

    # reference semantics: the Y-only regressions train on 1000x the
    # nominal batch (SolversJumpDiff.py:435,503)
    batch = config.batch_size * (
        config.reg_batch_multiplier
        if scheme in ("sumlocal_reg", "multistep_reg") else 1)
    val_batch = config.batch_size * 10
    if mesh is not None:
        batch = per_shard_batch(batch, mesh)
        val_batch = per_shard_batch(val_batch, mesh)
        if verbose:
            print(f"  data-parallel over {mesh.shape['data']} rank(s), "
                  f"{batch} paths a rank")
    res = fit(loss_fn=solver.build_loss(batch), params=params, seed=seed,
              lrate=config.lrate_for(method), num_epoch=config.n_epoch,
              num_epoch_ext=config.n_epoch_ext,
              val_loss_fn=solver.build_loss(val_batch),
              y0_fn=solver.y0_estimate, verbose=verbose, on_epoch=on_epoch,
              start_epoch=start_epoch, optimizer_state=optimizer_state,
              mesh=mesh)
    y0 = _y0_readout(res.y0_history, config.y0_tail_avg)
    ref = model.price_at_origin()
    return MethodResult(method=method, y0_history=res.y0_history,
                        loss_history=res.loss_history, duration=res.duration,
                        y0=y0, abs_error=abs(y0 - ref), params=res.params,
                        sweep_impl=solver.sweep_impl)


def run_pricing(config, verbose: bool = True,
                device: str = "cuda") -> PricingRunResult:
    """The mainMerton/mainVG sweep: train every method of
    ``config.methods``, compare with the oracle price, and write what
    ``config.io`` asks for."""
    with optional_mesh(config.data_parallel, device) as mesh:
        return _run_pricing(config, verbose, device, mesh)


def _run_pricing(config, verbose: bool, device: str,
                 mesh) -> PricingRunResult:
    model = build_model(config)
    ref_price = model.price_at_origin()
    io = config.io
    main = mesh is None or mesh.rank == 0
    verbose = verbose and main
    logger = None
    if io.outdir and io.metrics_jsonl:
        if main:
            os.makedirs(io.outdir, exist_ok=True)
        exp = "merton" if isinstance(config, MertonConfig) else "vg"
        logger = MetricsLogger(os.path.join(io.outdir, "metrics.jsonl"),
                               tags={"experiment": exp}, mesh=mesh)
        logger.log(event="start", reference_price=ref_price, device=device,
                   ranks=1 if mesh is None else mesh.size,
                   config={k: str(v) for k, v in
                           dataclasses.asdict(config).items()})

    results: Dict[str, MethodResult] = {}
    with trace_profile(io.profile_dir if main else None):
        for method in config.methods:
            if verbose:
                print(f"==== method {method} (oracle price {ref_price:.6f})"
                      " ====")
            mlog = logger.child(method=method) if logger else None
            results[method] = _train_one(config, model, method, mlog,
                                         verbose, device, mesh)
            if logger:
                r = results[method]
                logger.log(event="method_done", method=method, y0=r.y0,
                           abs_error=r.abs_error, duration_s=r.duration,
                           sweep_impl=r.sweep_impl)

    if io.outdir and io.save_plots and main:
        _plot_convergence(config, ref_price, results)
    if logger:
        logger.close()
    if mesh is not None:
        mesh.barrier()
    return PricingRunResult(reference_price=ref_price, methods=results)


def _plot_convergence(config, ref_price: float,
                      results: Dict[str, MethodResult]):
    """The reference's Y0-against-epoch overlay (mainMerton.py:124-128),
    written to ``convergence.png`` instead of plt.show()."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(10, 6))
    for method, res in results.items():
        ax.plot(res.y0_history, label=f"Y0 DL {method}")
    ax.plot(ref_price * np.ones(config.n_epoch_ext),
            label="Y0 closed formula", linestyle="dashed")
    ax.grid()
    ax.set(xlabel="outer epoch", ylabel="Y0")
    ax.legend()
    fig.savefig(os.path.join(config.io.outdir, "convergence.png"), dpi=120,
                bbox_inches="tight")
    plt.close(fig)
