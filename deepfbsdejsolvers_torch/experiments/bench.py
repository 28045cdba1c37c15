"""The training-throughput benchmark of the JAX package's ``bench.py``, on
the card.

    python -m deepfbsdejsolvers_torch.experiments.bench [--batch 131072]
        [--inner 10] [--rounds 3] [--model merton|vg|mfg] [--parity]
        [--compensator quadrature|mc] [--sweep xla|pallas] [--fused]
        [--fusedPrecision default|highest] [--adjoint] [--rng threefry|rbg]
        [--scheme global|...] [--device cuda|cpu]

(also ``python -m deepfbsdejsolvers_torch bench ...``, the CLI's
subcommand).  It builds the cell that ``bench.py`` builds, field for field
(``build``): the Merton speed configuration (icdf jumps, a Chebyshev
price, the compensator collocated at 64 Chebyshev points, hoisted
piecewise tables; with ``--fused`` the fused rollout, kernels B1/B2), the
Merton parity configuration (exact jumps, the series price, the
compensator swept at every path; ``--sweep`` defaults to the kernels B3/B4,
"pallas", on the card and to the plain sweep, "xla", on the CPU), the
Variance-Gamma speed and parity configurations, or the smart-grid MFG
model's global scheme with its coupled loss (the icdf Cox sampler unless
``--parity``), and any of the seven pricing schemes through ``--scheme``;
Adam at 4e-4, 1e-3 for the MFG model.  The speed cells keep ``bench.py``'s
scan chunks (2, and 16 for the MFG model: ``ops/scan.py``).  ``--adjoint``
trains the Merton speed cell through the hand-written adjoint
(``solvers/adjoint.py``), ``--fusedPrecision`` sets the fused rollout's
``fused_precision`` as ``bench.py`` does (its select dots; both values give
the port's kernels the same bits).

``--rng`` picks ``bench.py``'s key implementation.  The port draws from
PyTorch's generator for both values (on the card Philox4x32-10, on the CPU
the Mersenne twister); the ``# detail:`` record names the value given and
the generator used.  ``rbg`` keys in the JAX package run XLA's
RngBitGenerator with the algorithm DEFAULT, "the platform's default
algorithm" (``jax/_src/lax/lax.py``); on the CPU the installed jax 0.9.0
gives Philox's bits for it, and which algorithm its GPU backend takes is
compiled into jaxlib and not read here.

``measure`` follows ``bench.py``'s protocol: two warm-up epochs of
``inner`` Adam steps on the noise of generators (1, 1000 + w), then
``rounds`` epochs on generators (1, r), each timed on the host clock
between two ``torch.cuda.synchronize()`` calls; the result is the median
epoch.  The last line of standard output is ``bench.py``'s JSON object:
``metric`` ("{model}_{scheme}_train_throughput"), ``value`` in
paths·steps/s, ``unit`` and ``vs_baseline``, the ratio to the anchor in
``bench_baseline.json`` beside the package (read, never written: the JAX
package on a CPU, ``TFRT_CPU_0`` at batch 8192, not a card number) for the
Merton global cell, else null.  A ``# detail:`` line on standard error
gives the epochs' seconds, the final loss and the device's name.

Refused with exit status 2: ``--anchor`` (it would rewrite
``bench_baseline.json``), and a run on the card without one unless
``--device cpu``.  ``bench.py``'s watchdog, which re-runs a stalled
TPU client, has no counterpart here.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path
from typing import Optional, Sequence

import torch

ANCHOR_FILE = Path(__file__).resolve().parents[2] / "bench_baseline.json"
SCHEMES = ["global", "multistep1", "multistep2", "sumlocal1", "sumlocal2",
           "sumlocal_reg", "multistep_reg"]
# The time steps the unit string names, as bench.py prints them
UNIT_STEPS = {"merton": 50, "vg": 30, "mfg": 96}


def build(batch: int, compensator: str, parity: bool,
          model_name: str = "merton", sweep: Optional[str] = None,
          fused: bool = False, scheme: str = "global",
          device: str = "cuda", adjoint: bool = False,
          fused_precision: Optional[str] = None):
    """(model, solver, params, optimizer, loss_fn) of one cell of
    ``bench.py``'s ``build``, on ``device``: params drawn from generator
    (0, 0), ``loss_fn(params, generator)`` at ``batch``."""
    from deepfbsdejsolvers_torch.nets.mlp import param_leaves
    from deepfbsdejsolvers_torch.ops.compensator import CompensatorSpec
    from deepfbsdejsolvers_torch.solvers.pricing import PricingSolver
    from deepfbsdejsolvers_torch.solvers.train import (
        make_adam, make_generator)

    on_card = torch.device(device).type == "cuda"
    lrate = 4e-4
    if model_name == "vg":
        from deepfbsdejsolvers_torch.models.variance_gamma import (
            make_vg_default)

        model = make_vg_default()
        if parity:
            solver = PricingSolver(
                model, scheme, compensator=CompensatorSpec(kind=compensator),
                device=device)
        else:
            # collocated FFT price and compensator, icdf gamma jumps
            model = dataclasses.replace(model, price_eval="chebyshev",
                                        jump_sampler="icdf")
            solver = PricingSolver(
                model, scheme,
                compensator=CompensatorSpec(kind=compensator,
                                            x_interp="chebyshev", n_cheb=64),
                hoist=True, hoist_interp="piecewise", scan_chunk=2,
                device=device)
    elif model_name == "mfg":
        from deepfbsdejsolvers_torch.models.mfg_smart_grid import (
            make_mfg_default)
        from deepfbsdejsolvers_torch.solvers.mfg import MFGSolver

        model = make_mfg_default()
        if not parity:
            model = dataclasses.replace(model, jump_sampler="icdf")
        solver = MFGSolver(model, "global", scan_chunk=0 if parity else 16,
                           device=device)
        lrate = 1e-3
    elif parity:
        from deepfbsdejsolvers_torch.models.merton import make_merton_default

        model = make_merton_default()
        solver = PricingSolver(
            model, scheme, compensator=CompensatorSpec(kind=compensator),
            sweep_impl=sweep or ("pallas" if on_card else "xla"),
            device=device)
    else:
        from deepfbsdejsolvers_torch.models.merton import make_merton_default

        model = make_merton_default(jump_sampler="icdf",
                                    price_mode="chebyshev")
        solver = PricingSolver(
            model, scheme,
            compensator=CompensatorSpec(kind=compensator,
                                        x_interp="chebyshev", n_cheb=64),
            hoist=True, hoist_interp="piecewise", scan_chunk=2,
            sweep_impl=sweep or "xla", adjoint=adjoint, fused_rollout=fused,
            fused_precision=fused_precision, device=device)
    params = solver.init_params(make_generator("cpu", 0, 0))
    for t in param_leaves(params):
        t.requires_grad_(True)
    if model_name == "mfg":
        loss_fn = solver.build_losses(batch)["coupled"]
    else:
        loss_fn = solver.build_loss(batch)
    return model, solver, params, make_adam(params, lrate), loss_fn


def generator_name(device) -> str:
    """The algorithm of PyTorch's generator on ``device``."""
    return ("Philox4x32-10" if torch.device(device).type == "cuda"
            else "mt19937")


def measure(batch: int, inner: int, rounds: int, compensator: str,
            parity: bool = False, model_name: str = "merton",
            sweep: Optional[str] = None, fused: bool = False,
            scheme: str = "global", device: str = "cuda",
            adjoint: bool = False, fused_precision: Optional[str] = None,
            rng: str = "threefry") -> dict:
    """``bench.py``'s protocol on ``device``: 2 warm-up epochs, then
    ``rounds`` timed epochs of ``inner`` Adam steps; the median epoch's
    rates, every epoch's seconds, the last step's loss, the device, and the
    ``rng`` asked for beside the generator drawn from."""
    from deepfbsdejsolvers_torch.solvers.train import (
        make_generator, make_step)

    model, _, params, optimizer, loss_fn = build(
        batch, compensator, parity, model_name, sweep, fused, scheme, device,
        adjoint, fused_precision)
    step = make_step(loss_fn, optimizer, params)
    dev = torch.device(device)
    wait = ((lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda"
            else (lambda: None))

    def epoch(tag: int):
        gen = make_generator(dev, 1, tag)
        for _ in range(inner):
            loss = step(gen)
        return loss

    for w in range(2):
        epoch(1000 + w)
        wait()
    per_round = []
    for r in range(rounds):
        wait()
        t0 = time.perf_counter()
        loss = epoch(r)
        wait()
        per_round.append(time.perf_counter() - t0)
    med = sorted(per_round)[len(per_round) // 2]
    return {
        "paths_steps_per_sec": batch * model.N * inner / med,
        "train_steps_per_sec": inner / med,
        "round_seconds": per_round,
        "final_loss": float(loss),
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "rng": rng,
        "generator": generator_name(dev),
    }


def refusal(anchor: bool = False) -> Optional[str]:
    """Why the port refuses these ``bench.py`` options, or None."""
    if anchor:
        return ("--anchor: bench_baseline.json is the JAX package's CPU "
                "anchor and is not rewritten")
    return None


def usage_error(parity: bool, model: str, fused: bool, scheme: str,
                sweep: Optional[str], fused_precision: Optional[str],
                adjoint: bool = False) -> Optional[str]:
    """``bench.py``'s own argument errors, and the port's two more (the
    fused rollout and the adjoint run the global scheme only: the port
    refuses where the JAX package falls back), or None."""
    if fused and (parity or model != "merton"):
        return ("--fused applies only to the merton speed config (no "
                "--parity, --model merton)")
    if fused and scheme != "global":
        return "--fused applies only to the global scheme"
    if fused_precision and not fused:
        return "--fusedPrecision requires --fused"
    if adjoint and (parity or model != "merton"):
        return ("--adjoint applies only to the merton speed config (no "
                "--parity, --model merton)")
    if adjoint and scheme != "global":
        return "--adjoint applies only to the global scheme"
    if sweep and model in ("vg", "mfg"):
        return ("--sweep applies only to --model merton (the vg/mfg "
                "builders take no sweep implementation)")
    if scheme != "global" and model == "mfg":
        return ("--scheme applies to the pricing models (merton/vg); the "
                "MFG workload benches its global scheme")
    return None


def run(batch: int, inner: int, rounds: int, compensator: str,
        parity: bool, model: str, sweep: Optional[str], fused: bool,
        scheme: str, device: str, adjoint: bool = False,
        fused_precision: Optional[str] = None,
        rng: str = "threefry") -> int:
    """Measure one cell and print ``bench.py``'s JSON line (and the
    ``# detail:`` line on standard error); returns the exit status: 2
    without a card unless ``device`` is the CPU."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        print("bench: no CUDA device; pass --device cpu to run on the CPU",
              file=sys.stderr)
        return 2
    res = measure(batch, inner, rounds, compensator, parity, model, sweep,
                  fused, scheme, device, adjoint, fused_precision, rng)
    vs = None
    if model == "merton" and scheme == "global" and ANCHOR_FILE.is_file():
        anchor = json.loads(ANCHOR_FILE.read_text())
        vs = res["paths_steps_per_sec"] / anchor["anchor_paths_steps_per_sec"]
    tag = "global" if model == "mfg" else scheme
    print(json.dumps({
        "metric": f"{model}_{tag}_train_throughput",
        "value": res["paths_steps_per_sec"],
        "unit": f"paths*steps/sec/chip ({model} N={UNIT_STEPS[model]}, "
                f"batch 2^{batch.bit_length() - 1})",
        "vs_baseline": vs,
    }))
    print(f"# detail: {res}", file=sys.stderr)
    return 0


def build_parser() -> argparse.ArgumentParser:
    """``bench.py``'s flags letter for letter, and ``--device``."""
    p = argparse.ArgumentParser(
        prog="python -m deepfbsdejsolvers_torch.experiments.bench",
        description="Training throughput of one cell, on the card")
    p.add_argument("--batch", type=int, default=2**17)
    p.add_argument("--inner", type=int, default=10)
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("--compensator", choices=["quadrature", "mc"],
                   default="quadrature")
    p.add_argument("--model", choices=["merton", "vg", "mfg"],
                   default="merton",
                   help="secondary workloads: VG pure-jump pricing (N=30) or "
                        "the coupled MFG smart-grid system (N=96)")
    p.add_argument("--scheme", default="global", choices=SCHEMES,
                   help="pricing training scheme; the headline metric is "
                        "the global scheme")
    p.add_argument("--parity", action="store_true",
                   help="reference-faithful numerics (f32, exact sampler, "
                        "49-node/MC sweep) instead of the speed config")
    p.add_argument("--sweep", choices=["xla", "pallas"], default=None,
                   help="parity-mode compensator sweep: 'pallas' the "
                        "kernels B3/B4, 'xla' the plain sweep (default: "
                        "pallas on the card, xla on the CPU)")
    p.add_argument("--rng", choices=["threefry", "rbg"], default="threefry",
                   help="bench.py's key implementation; the port draws "
                        "from PyTorch's generator for both")
    p.add_argument("--adjoint", action=argparse.BooleanOptionalAction,
                   default=False,
                   help="hand-written adjoint for the merton speed config "
                        "(solvers/adjoint.py)")
    p.add_argument("--fused", action=argparse.BooleanOptionalAction,
                   default=False,
                   help="fused whole-rollout kernels B1/B2 for the merton "
                        "speed config")
    p.add_argument("--fusedPrecision", choices=["default", "highest"],
                   default=None,
                   help="select precision for --fused (the kernels select "
                        "by index: both give the same bits)")
    p.add_argument("--anchor", action="store_true",
                   help="measure the CPU anchor (refused: "
                        "bench_baseline.json is read only)")
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (the default) or 'cpu'")
    return p


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = build_parser()
    args = p.parse_args(argv)
    err = usage_error(args.parity, args.model, args.fused, args.scheme,
                      args.sweep, args.fusedPrecision, args.adjoint)
    if err:
        p.error(err)
    why = refusal(args.anchor)
    if why:
        print(f"bench: {why}", file=sys.stderr)
        return 2
    return run(args.batch, args.inner, args.rounds, args.compensator,
               args.parity, args.model, args.sweep, args.fused, args.scheme,
               args.device, args.adjoint, args.fusedPrecision, args.rng)


if __name__ == "__main__":
    sys.exit(main())
