"""One CLI for the experiments: ``python -m deepfbsdejsolvers_torch <cmd>``.

The subcommands of the JAX package's CLI, with its flags letter for letter
(the reference's names: ``--nbNeuron``, ``--nEpochExt``, ...), so that a
reference command line runs as it is, on the card:

merton        the seven-method pricing sweep on the Merton model (mainMerton)
vg            the seven-method pricing sweep on the Variance-Gamma model
              (mainVG)
mfg-compare   the five-method MFG comparison (mainMFGComparison)
mfg-poa       the Price-of-Anarchy case sweep (mainMFGPoA)
bench         the training-throughput benchmark (the JAX package's
              bench.py), in this process (experiments/bench.py)

One flag more, ``--device`` (``cuda`` by default; ``cpu`` runs on the CPU):
without a card and without ``--device cpu`` the CLI exits with status 2,
and so do the bench options the port has not (``experiments/bench.py``).

``--dataParallel`` shards the path batch over the ranks of the launcher's
world: ``python -m torch.distributed.run --nproc_per_node K -m
deepfbsdejsolvers_torch merton --dataParallel ...`` runs K ranks (NCCL with
a card each, gloo where they share one; ``parallel/data_parallel.py``), and
rank 0 alone writes under ``--outdir`` and prints the summary.  Without the
launcher it runs a world of one.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
from typing import Optional, Sequence

import torch

from deepfbsdejsolvers_torch.experiments.configs import (
    MFG_METHODS, PRICING_METHODS, MertonConfig, MFGComparisonConfig,
    MFGPoAConfig, RunIO, VGConfig)

def _add_io_flags(p: argparse.ArgumentParser):
    p.add_argument("--outdir", type=str, default=None,
                   help="artifact directory (metrics.jsonl, plots, ckpts)")
    p.add_argument("--savePlots", action="store_true")
    p.add_argument("--checkpointEvery", type=int, default=0,
                   help="outer epochs between checkpoints (0 = off)")
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest checkpoint in outdir")
    p.add_argument("--profileDir", type=str, default=None,
                   help="capture a torch.profiler trace here, and the "
                        "training step's spans (span_summary and the raw "
                        "spans, utils/profiling.py) beside it")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--debugNans", action="store_true",
                   help="enable the NaN guard: autograd's anomaly mode "
                        "with its NaN check, and a raise on a non-finite "
                        "training loss (slows training; utils/debug.py)")
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (the default) or 'cpu'")


def _io_from_args(args) -> RunIO:
    return RunIO(outdir=args.outdir, save_plots=args.savePlots,
                 checkpoint_every=args.checkpointEvery, resume=args.resume,
                 profile_dir=args.profileDir)


def _add_pricing_flags(p: argparse.ArgumentParser, lr_y0, lr_loc, lr_reg,
                       methods):
    p.add_argument("--nbNeuron", type=int, default=21)
    p.add_argument("--nbLayer", type=int, default=2)
    p.add_argument("--nEpochExt", type=int, default=120)
    p.add_argument("--nEpoch", type=int, default=100)
    p.add_argument("--batchSize", type=int, default=10)
    p.add_argument("--lRateY0", type=float, default=lr_y0)
    p.add_argument("--lRateLoc", type=float, default=lr_loc)
    p.add_argument("--lRateReg", type=float, default=lr_reg)
    p.add_argument("--activation", type=str, default="tanh",
                   choices=["tanh", "relu", "sigmoid"])
    p.add_argument("--aLin", type=float, default=0.1)
    p.add_argument("--methods", type=str, nargs="*", default=list(methods),
                   choices=list(methods))
    p.add_argument("--compensator", type=str, default="quadrature",
                   choices=["quadrature", "mc"],
                   help="inner jump-expectation mode (reference = mc 5000)")
    p.add_argument("--nMC", type=int, default=5000)
    p.add_argument("--sweepImpl", type=str, default=None,
                   choices=["xla", "pallas"],
                   help="compensator sweep: 'pallas' runs the CUDA kernels "
                        "B3/B4 for the methods whose head they take, 'xla' "
                        "the plain PyTorch sweep.  Default: pallas on the "
                        "card for un-hoisted runs, xla under --fast and on "
                        "the CPU")
    p.add_argument("--dataParallel", action="store_true",
                   help="shard the path batch over the ranks of the "
                        "launcher's world (torch.distributed.run; a world "
                        "of one without it)")
    p.add_argument("--y0TailAvg", type=int, default=1,
                   help="report Y0 as the mean over the last k outer epochs "
                        "(1 = reference behavior)")
    p.add_argument("--y0WarmStart", action="store_true",
                   help="init the Global scheme's trainable Y0 at an "
                        "oracle-free MC payoff estimate (robustness: avoids "
                        "the spurious basin ~1/3 of std-normal inits hit)")
    p.add_argument("--fast", action="store_true",
                   help="speed preset (accuracy-gated, full f32): "
                        "Chebyshev-collocated compensator (64 points, full "
                        "node rule) and price, inverse-CDF jump sampling, "
                        "hoisted piecewise tables")


def _resolve_sweep_impl(choice, device: str, hoisted: bool = False) -> str:
    """The default of --sweepImpl, the JAX package's policy: the kernels
    ("pallas") for un-hoisted runs on the card, the plain sweep ("xla")
    under --fast (hoisted tables: the JAX package measured its kernel's
    tables failing the merton_speed_mc gate) and on the CPU.  An explicit
    choice stands."""
    if choice is not None:
        return choice
    if hoisted or torch.device(device).type != "cuda":
        return "xla"
    return "pallas"


def _pricing_common(args) -> dict:
    fast = {}
    if args.fast:
        # the accuracy-gated speed preset: Chebyshev-collocated compensator
        # (full node rule) and price, icdf jump sampling, hoisted tables
        fast = dict(x_interp="chebyshev", n_cheb=64, jump_sampler="icdf",
                    price_mode="chebyshev", hoist=True,
                    hoist_interp="piecewise", scan_chunk=2)
    return dict(
        nb_neuron=args.nbNeuron, nb_layer=args.nbLayer,
        n_epoch_ext=args.nEpochExt, n_epoch=args.nEpoch,
        batch_size=args.batchSize, lrate_y0=args.lRateY0,
        lrate_loc=args.lRateLoc, lrate_reg=args.lRateReg,
        activation=args.activation, a_lin=args.aLin, methods=args.methods,
        compensator=args.compensator, n_mc=args.nMC, seed=args.seed,
        sweep_impl=_resolve_sweep_impl(args.sweepImpl, args.device,
                                       hoisted=args.fast),
        data_parallel=args.dataParallel, y0_tail_avg=args.y0TailAvg,
        y0_warm_start=args.y0WarmStart, io=_io_from_args(args), **fast,
    )


def _add_mfg_flags(p: argparse.ArgumentParser, defaults):
    p.add_argument("--nbNeuron_hat", type=int, default=defaults.nb_neuron_hat)
    p.add_argument("--nbNeuron", type=int, default=defaults.nb_neuron)
    p.add_argument("--nbLayer_hat", type=int, default=defaults.nb_layer_hat)
    p.add_argument("--nbLayer", type=int, default=defaults.nb_layer)
    p.add_argument("--nEpochExt", type=int, default=defaults.n_epoch_ext)
    p.add_argument("--nEpoch", type=int, default=defaults.n_epoch)
    p.add_argument("--batchSize", type=int, default=defaults.batch_size)
    p.add_argument("--rafCoef", type=int, default=defaults.raf_coef)
    p.add_argument("--jumpFac", type=float, default=defaults.jump_factor)
    p.add_argument("--nbDays", type=int, default=defaults.nb_days)
    p.add_argument("--lRateY0", type=float, default=defaults.lrate_y0)
    p.add_argument("--lRateLoc", type=float, default=defaults.lrate_loc)
    p.add_argument("--lRateReg", type=float, default=defaults.lrate_reg)
    p.add_argument("--couplage", type=str, default="ON", choices=["ON", "OFF"])
    p.add_argument("--jumpModel", type=str, default="stochastic",
                   choices=["stochastic", "constant"])
    p.add_argument("--activation_hat", type=str, default="tanh",
                   choices=["tanh", "relu", "sigmoid"])
    p.add_argument("--activation", type=str, default="tanh",
                   choices=["tanh", "relu", "sigmoid"])
    p.add_argument("--dataParallel", action="store_true",
                   help="shard the path batch over the ranks of the "
                        "launcher's world (torch.distributed.run; a world "
                        "of one without it)")
    p.add_argument("--y0WarmStart", action="store_true",
                   help="initialize the Global scheme's trainable (Y0_hat, "
                        "Y0) at Picard-iterated MC estimates of the BSDE "
                        "initial values instead of the reference's std-1 "
                        "normal draws")
    p.add_argument("--fast", action="store_true",
                   help="speed preset: the icdf Cox jump sampler (same law, "
                        "tested against the exact sampler in tests/) and "
                        "the time loop checkpointed 16 steps a chunk")


def _mfg_common(args) -> dict:
    fast = {}
    if args.fast:
        fast = dict(jump_sampler="icdf", scan_chunk=16)
    return dict(
        nb_neuron_hat=args.nbNeuron_hat, nb_neuron=args.nbNeuron,
        nb_layer_hat=args.nbLayer_hat, nb_layer=args.nbLayer,
        n_epoch_ext=args.nEpochExt, n_epoch=args.nEpoch,
        batch_size=args.batchSize, raf_coef=args.rafCoef,
        jump_factor=args.jumpFac, nb_days=args.nbDays,
        lrate_y0=args.lRateY0, lrate_loc=args.lRateLoc,
        lrate_reg=args.lRateReg, couplage=args.couplage,
        jump_model=args.jumpModel, activation_hat=args.activation_hat,
        activation=args.activation, data_parallel=args.dataParallel,
        y0_warm_start=args.y0WarmStart,
        seed=args.seed, io=_io_from_args(args), **fast,
    )


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="deepfbsdejsolvers_torch",
        description="Deep FBSDE solvers with jumps, in PyTorch on one CUDA "
                    "card")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("merton", help="Merton pricing sweep (mainMerton)")
    _add_pricing_flags(p, 4e-4, 3e-4, 3e-4, PRICING_METHODS)
    p.add_argument("--limit", type=int, default=30)
    _add_io_flags(p)

    p = sub.add_parser("vg", help="Variance-Gamma pricing sweep (mainVG)")
    _add_pricing_flags(p, 5e-4, 3e-4, 1.5e-4, PRICING_METHODS)
    p.add_argument("--pricer", type=str, default="fft",
                   choices=["fft", "invfourier"])
    _add_io_flags(p)

    p = sub.add_parser("mfg-compare", help="MFG method comparison")
    _add_mfg_flags(p, MFGComparisonConfig())
    p.add_argument("--methods", type=str, nargs="*", default=list(MFG_METHODS),
                   choices=list(MFG_METHODS))
    p.add_argument("--nbSimulation", type=int, default=10**5)
    _add_io_flags(p)

    p = sub.add_parser("mfg-poa", help="Price-of-Anarchy sweep")
    _add_mfg_flags(p, MFGPoAConfig())
    p.add_argument("--method", type=str, default="Global",
                   choices=list(MFG_METHODS))
    p.add_argument("--nFrozen", type=int, default=1000,
                   help="frozen-noise trajectories (reference nbSimul)")
    p.add_argument("--nReplay", type=int, default=5,
                   help="paths plotted per sweep point (reference "
                        "NbSimulation)")
    p.add_argument("--piList", type=float, nargs="*",
                   default=[0.0, 0.1, 0.5, 0.95])
    _add_io_flags(p)

    p = sub.add_parser("bench", help="training-throughput benchmark "
                                     "(bench.py)")
    p.add_argument("--batch", type=int, default=2**17)
    p.add_argument("--inner", type=int, default=10)
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("--model", type=str, default="merton",
                   choices=["merton", "vg", "mfg"])
    p.add_argument("--parity", action="store_true",
                   help="reference-faithful numerics instead of the speed "
                        "config (see experiments/bench.py)")
    p.add_argument("--compensator", type=str, default="quadrature",
                   choices=["quadrature", "mc"])
    p.add_argument("--sweep", type=str, default=None,
                   choices=["xla", "pallas"])
    p.add_argument("--rng", type=str, default="threefry",
                   choices=["threefry", "rbg"])
    p.add_argument("--fused", action="store_true",
                   help="fused whole-rollout kernels B1/B2 for the merton "
                        "speed config")
    p.add_argument("--fusedPrecision", type=str, default=None,
                   choices=["default", "highest"])
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (the default) or 'cpu'")
    return parser


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if (torch.device(args.device).type == "cuda"
            and not torch.cuda.is_available()):
        print("deepfbsdejsolvers_torch: no CUDA device; pass --device cpu "
              "to run on the CPU", file=sys.stderr)
        return 2
    from deepfbsdejsolvers_torch.utils.debug import nan_guard

    guard = (nan_guard() if getattr(args, "debugNans", False)
             else contextlib.nullcontext())
    with guard:
        return _dispatch(args, not getattr(args, "quiet", False))


def _bench(args) -> int:
    """The bench subcommand: ``experiments/bench.py``'s run of the global
    scheme, after its argument checks (exit status 2)."""
    from deepfbsdejsolvers_torch.experiments import bench

    why = bench.usage_error(args.parity, args.model, args.fused, "global",
                            args.sweep, args.fusedPrecision)
    if why:
        print(f"deepfbsdejsolvers_torch bench: {why}", file=sys.stderr)
        return 2
    return bench.run(args.batch, args.inner, args.rounds, args.compensator,
                     args.parity, args.model, args.sweep, args.fused,
                     "global", args.device,
                     fused_precision=args.fusedPrecision, rng=args.rng)


def _dispatch(args, verbose: bool) -> int:
    if args.cmd == "bench":
        return _bench(args)
    # a launcher's ranks other than 0 print nothing
    show = os.environ.get("RANK", "0") == "0"
    verbose = verbose and show
    say = print if show else (lambda *a: None)
    if args.cmd in ("merton", "vg"):
        from deepfbsdejsolvers_torch.experiments.pricing import run_pricing

        if args.cmd == "merton":
            cfg = MertonConfig(limit=args.limit, **_pricing_common(args))
            label = "closed-form price"
        else:
            cfg = VGConfig(pricer=args.pricer, **_pricing_common(args))
            label = "FFT reference price"
        res = run_pricing(cfg, verbose=verbose, device=args.device)
        for m, r in res.methods.items():
            say(f"{m}: Y0={r.y0:.6f}  |err|={r.abs_error:.2e}  "
                  f"({r.duration:.1f}s, sweep {r.sweep_impl})")
        say(f"{label}: {res.reference_price:.6f}")
    elif args.cmd == "mfg-compare":
        from deepfbsdejsolvers_torch.experiments.mfg_comparison import (
            run_mfg_comparison)

        cfg = MFGComparisonConfig(methods=args.methods,
                                  n_simulation=args.nbSimulation,
                                  **_mfg_common(args))
        res = run_mfg_comparison(cfg, verbose=verbose, device=args.device)
        for m, r in res.methods.items():
            cost = ("" if r.eval_cost is None
                    else f"  cost={r.eval_cost:.4f}±{r.eval_ci:.4f}")
            say(f"{m}: Y0_hat={r.y0_hat_history[-1]:.6f}  "
                  f"Y0={r.y0_history[-1]:.6f}{cost}")
    else:
        from deepfbsdejsolvers_torch.experiments.mfg_poa import (
            TABLE_COLUMNS, run_mfg_poa)

        cfg = MFGPoAConfig(method=args.method, n_frozen=args.nFrozen,
                           n_replay=args.nReplay, pi_list=args.piList,
                           **_mfg_common(args))
        res = run_mfg_poa(cfg, verbose=verbose, device=args.device)
        say("  ".join(TABLE_COLUMNS))
        for row in res.table():
            say("  ".join(str(row[c]) for c in TABLE_COLUMNS))
    return 0


if __name__ == "__main__":
    sys.exit(main())
