"""Training-step times of the port's accuracy gates on one CUDA card, each
gate alone in this process.

    python3 step_probe.py [GATE ...] [--steps 20] [--clenshaw]

For each gate of the port's runner
(``deepfbsdejsolvers_torch.experiments.convergence_gates``; by default
merton_speed, merton_speed_mc and merton_direct) it builds the gate's
solver at its registered configuration (for an extrapolated gate, the
solver of its fit at the full coupling; the gate trains two such fits per
seed; for an MFG row the ``MFGSolver`` of its scheme on its coupled loss,
for ``mfg_consensus`` that of its global scheme, one of its two fits per
seed) and takes Adam steps at the gate's batch and peak learning rate: 3 untimed, then ``--steps`` back to back
between two CUDA events (queued as the runner's ``fit`` queues them, one
wait at the end), then 2 under ``chip_smoke.profile_steps`` (device busy
time, idle share, device operations per step, the largest kernels).  From
the step time it gives the gate's training time, seeds × steps × step, the
warm start and evaluations left out.

``--clenshaw`` times each gate in turns, A B B A, where A evaluates every
Chebyshev series (``chebyshev.cheb_eval``, ``piecewise.pw_eval``) by
Clenshaw's recurrence under autograd, several autograd nodes per term, and
B by ``chebyshev.ChebSeries``, one node per evaluation.  The two give the
same values up to rounding.

Prints the card's name and power limit.  Exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import inspect
import subprocess
import sys
import time

import torch

GATES = ("merton_speed", "merton_speed_mc", "merton_direct")


def clenshaw(coef: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """sum_j coef[..., j] T_j(u) by Clenshaw's recurrence, autograd through
    every term."""
    b1 = torch.zeros_like(u)
    b2 = b1
    for j in range(coef.shape[-1] - 1, 0, -1):
        b1, b2 = coef[..., j] + 2.0 * u * b1 - b2, b1
    return coef[..., 0] + u * b1 - b2


def use_series(series) -> None:
    """Make ``series(coef, u)`` the evaluator of every Chebyshev series."""
    from deepfbsdejsolvers_torch.ops import chebyshev, piecewise

    chebyshev.cheb_series = piecewise.cheb_series = series


def gate_step(name: str, device: str = "cuda"):
    """(step, generator, batch, updates) of the gate ``name``: one Adam step
    of its solver at its batch and peak rate, on fresh noise each call."""
    from deepfbsdejsolvers_torch.experiments import convergence_gates as cg
    from deepfbsdejsolvers_torch.nets.mlp import param_leaves
    from deepfbsdejsolvers_torch.solvers.mfg import MFGSolver
    from deepfbsdejsolvers_torch.solvers.pricing import PricingSolver
    from deepfbsdejsolvers_torch.solvers.train import (
        make_adam, make_generator, make_step)

    entry = cg.build_registry()[name]
    args = dict(entry["args"])
    runner = {"extrapolated": cg.run_extrapolated_gate,
              "mfg_lq": cg.run_mfg_lq_gate,
              "mfg_consensus": cg.run_mfg_consensus_gate}.get(entry["kind"],
                                                              cg.run_gate)
    defaults = inspect.signature(runner).parameters
    budget = {k: args.pop(k, defaults[k].default)
              for k in ("batch", "peak_lr", "steps", "seeds")}
    if entry["kind"].startswith("mfg"):
        # an LQ row fits its scheme once a seed; the consensus row fits
        # each of its schemes, and the first (global) is timed
        schemes = ((args["scheme"],) if "scheme" in args
                   else args.get("schemes", defaults["schemes"].default))
        solver = MFGSolver(args["model"], schemes[0], device=device)
        loss = solver.build_losses(budget["batch"])["coupled"]
        fits = len(schemes)
    else:
        fits = 1
        if entry["kind"] == "extrapolated":
            # two fits per seed, at aLin/2 and aLin, of the same cost
            a_lin = args.pop("a_lin", defaults["a_lin"].default)
            args["model"] = args.pop("make_model")(a_lin)
            args["scheme"] = "global"
            fits = 2
        for key in ("oracle", "tail", "warm_y0"):
            args.pop(key, None)
        solver = PricingSolver(args.pop("model"), args.pop("scheme"),
                               device=device, **args)
        loss = solver.build_loss(budget["batch"])
    params = solver.init_params(make_generator("cpu", 0))
    for t in param_leaves(params):
        t.requires_grad_(True)
    step = make_step(loss, make_adam(params, budget["peak_lr"]), params)
    return (step, make_generator(device, 1), budget["batch"],
            fits * budget["seeds"] * budget["steps"])


def steps_ms(step, gen, steps: int) -> float:
    """Mean milliseconds per step of ``steps`` steps queued back to back
    between two CUDA events, after 3 untimed steps."""
    for _ in range(3):
        step(gen)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(steps):
        loss = step(gen)
    end.record()
    torch.cuda.synchronize()
    if not torch.isfinite(loss):
        raise SystemExit("step_probe: a non-finite loss")
    return start.elapsed_time(end) / steps


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("gates", nargs="*", default=list(GATES))
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--clenshaw", action="store_true",
                   help="also time the Clenshaw evaluator, A B B A")
    opts = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("step_probe: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from deepfbsdejsolvers_torch.ops import chebyshev

    series_sum = chebyshev.cheb_series
    for name in opts.gates:
        t0 = time.perf_counter()
        step, gen, batch, updates = gate_step(name)
        turns = ((clenshaw, "clenshaw"), (series_sum, "series"))
        turns = turns + turns[::-1] if opts.clenshaw else turns[1:]
        times = []
        for series, label in turns:
            use_series(series)
            ms = steps_ms(step, gen, opts.steps)
            times.append((label, ms))
            print(f"{name} [{label}]: {ms:.3f} ms a step at batch {batch} "
                  f"({opts.steps} steps)", flush=True)
        use_series(series_sum)
        ms = min(t for label, t in times if label == "series")
        print(f"{name}: {updates} updates at {ms:.3f} ms -> "
              f"{updates * ms / 6e4:.1f} min of training", flush=True)
        chip_smoke.profile_steps(step, gen, ms, steps=2)
        print(f"{name}: {time.perf_counter() - t0:.1f} s in the probe",
              flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi or "nvidia-smi: no output")
    return 0


if __name__ == "__main__":
    sys.exit(main())
