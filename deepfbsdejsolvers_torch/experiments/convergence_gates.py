"""The pricing accuracy gates of the port, on the card.

    python -m deepfbsdejsolvers_torch.experiments.convergence_gates \\
        merton_speed vg_speed [--device cuda]

Each gate trains a solver on its registered budget (Adam under a
cosine-decayed learning rate, peak ``peak_lr`` over ``steps`` updates,
batch 8192, ``seeds`` independent runs) and reports |Y0 − oracle| against
the model's own price A(0, x0): the closed-form Merton price 0.271457, or
the Variance-Gamma Carr-Madan FFT price 0.133141.  A gate passes when the
largest error over its seeds is at most 1e-3.  The registry
(``build_registry``) holds the JAX package's gate script's ten Merton rows
and five Variance-Gamma rows with the same configuration and budget keys,
so a CPU test can train every row at a small budget and check that the
rows have not drifted.

Seeds are taken as in that script: the nets from ``seed``, the warm start
of Y0 from 9000 + seed, the training noise from 1 + 100·seed, each through
``make_generator``.  torch's Philox draws are not JAX's threefry draws, so
the per-seed numbers differ from the JAX package's; the 1e-3 bar is what
carries over.  Each gate prints one JSON record, the JAX script's keys plus
the seeds it trained, the device it ran on and its seconds.  ``--seed``
trains only the seeds named, so that a gate too long for one run can be
run a seed at a time.  The MFG rows wait for their model (ROADMAP
Queue 1, item 11).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np
import torch

from deepfbsdejsolvers_torch.models.merton import make_merton_default
from deepfbsdejsolvers_torch.models.variance_gamma import make_vg_default
from deepfbsdejsolvers_torch.ops.compensator import CompensatorSpec
from deepfbsdejsolvers_torch.solvers.pricing import PricingSolver
from deepfbsdejsolvers_torch.solvers.train import (
    cosine_decay_schedule, fit, make_generator)


def _device_name(device: str) -> str:
    dev = torch.device(device)
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return dev.type


def _fit_y0(solver, seed, batch, peak_lr, steps, tail, warm_y0, device,
            verbose):
    """One cosine-decayed fit from ``seed``; the mean Y0 read-out over its
    last max(tail // 4, 2) outer epochs of 400 steps.  ``verbose`` prints
    each outer epoch's loss, seconds and Y0."""
    params = solver.init_params(make_generator("cpu", seed))
    if warm_y0:
        params = solver.warm_start_y0(params,
                                      make_generator(device, 9000 + seed))
    num_epoch = min(400, steps)
    res = fit(loss_fn=solver.build_loss(batch), params=params,
              seed=1 + 100 * seed,
              lrate=cosine_decay_schedule(peak_lr, steps),
              num_epoch=num_epoch, num_epoch_ext=steps // num_epoch,
              y0_fn=solver.y0_estimate, verbose=verbose)
    return float(np.mean(res.y0_history[-max(tail // 4, 2):]))


def _seed_list(seeds):
    """The seeds a gate trains: 0 … seeds − 1 for a count, else the seed
    numbers given (one gate's seeds split over several runs)."""
    return list(range(seeds)) if isinstance(seeds, int) else list(seeds)


def _record(name, y0s, oracle, device, seconds, one_seed, seeds):
    errs = [abs(y0 - oracle) for y0 in y0s]
    record = {"gate": name, "seeds": seeds,
              "y0": y0s[0] if one_seed else y0s,
              "oracle": oracle, "abs_error": max(errs),
              "mean_error": float(np.mean(errs)),
              "pass_1e-3": max(errs) <= 1e-3,
              "device": _device_name(device), "seconds": seconds}
    print(json.dumps(record), flush=True)
    return record


def run_gate(name, model, oracle, scheme, batch=8192, peak_lr=6e-3,
             steps=4800, seeds=1, tail=12, warm_y0=False, device="cuda",
             verbose=False, **solver_kw):
    """Train ``seeds`` independent runs of ``scheme`` (a count, or the
    seed numbers) and report the per-seed Y0 and the largest and mean
    error; ``solver_kw`` passes to :class:`PricingSolver`."""
    t0 = time.perf_counter()
    solver = PricingSolver(model, scheme, device=device, **solver_kw)
    runs = _seed_list(seeds)
    y0s = [_fit_y0(solver, seed, batch, peak_lr, steps, tail, warm_y0,
                   device, verbose) for seed in runs]
    return _record(name, y0s, oracle, device, time.perf_counter() - t0,
                   seeds == 1, runs)


def run_extrapolated_gate(name, make_model, oracle, compensator, seeds=3,
                          a_lin=0.1, peak_lr=3e-3, steps=2400, tail=12,
                          batch=8192, device="cuda", verbose=False):
    """The Richardson-extrapolated coupled global gate: per seed, train the
    global scheme (warm Y0) at aLin/2 and aLin and report 2·Y0(aLin/2) −
    Y0(aLin), which cancels the coupling bias linear in aLin.
    ``make_model(a)`` builds the model at coupling strength a; ``seeds``
    is a count or the seed numbers."""
    t0 = time.perf_counter()
    y0s = []
    runs = _seed_list(seeds)
    for seed in runs:
        pair = []
        for a in (a_lin / 2, a_lin):
            solver = PricingSolver(make_model(a), "global",
                                   compensator=compensator, device=device)
            pair.append(_fit_y0(solver, seed, batch, peak_lr, steps, tail,
                                True, device, verbose))
        y0s.append(2.0 * pair[0] - pair[1])
    return _record(name, y0s, oracle, device, time.perf_counter() - t0,
                   False, runs)


def build_registry():
    """The gate matrix as data: name -> {"kind": "gate" | "extrapolated",
    "args": {...}}.  ``run_entry`` runs an entry; a smoke test overrides
    the budget keys (steps, seeds, batch, tail) and the device, never the
    configuration keys."""
    merton = make_merton_default()
    oracle = merton.price_at_origin()
    cheb64 = CompensatorSpec(x_interp="chebyshev", n_cheb=64)
    speed_kw = dict(compensator=cheb64, hoist=True, hoist_interp="piecewise")
    # the speed model: uncoupled, icdf jumps, collocated price
    speed = make_merton_default(a_lin=0.0, jump_sampler="icdf",
                                price_mode="chebyshev")
    warm = dict(seeds=3, peak_lr=3e-3, steps=2400, warm_y0=True)
    g = {}
    # the hoisted speed configuration, global scheme, warm Y0
    g["merton_speed"] = dict(model=speed, oracle=oracle, scheme="global",
                             **warm, **speed_kw)
    # the same through the fused rollout kernels B1/B2
    g["merton_speed_fused"] = dict(model=speed, oracle=oracle,
                                   scheme="global", **warm,
                                   fused_rollout=True, **speed_kw)
    # the reference-exact MC-5000 compensator law through the same tables
    g["merton_speed_mc"] = dict(
        model=speed, oracle=oracle, scheme="global", **warm,
        compensator=CompensatorSpec(kind="mc", n_mc=5000,
                                    x_interp="chebyshev", n_cheb=64),
        hoist=True, hoist_interp="piecewise")
    # multistep U(0, x0) read-outs, uncoupled and coupled: diagnostics
    g["merton_multistep_diag"] = dict(model=speed, oracle=oracle,
                                      scheme="multistep1",
                                      compensator=cheb64, seeds=3)
    g["merton_coupled_diag"] = dict(
        model=make_merton_default(jump_sampler="icdf",
                                  price_mode="chebyshev"),
        oracle=oracle, scheme="multistep1", compensator=cheb64, seeds=3)
    # the coupled global scheme at N = 1600, where the coupling bias
    # (~0.027/sqrt(N)) is inside the bar; the time feature is rescaled to
    # the N = 50 range
    g["merton_coupled_direct"] = dict(
        model=dataclasses.replace(
            make_merton_default(a_lin=0.1, jump_sampler="icdf",
                                price_mode="chebyshev"), N=1600),
        oracle=oracle, scheme="global", seeds=3, peak_lr=3e-3, steps=2400,
        warm_y0=True, time_scale=50.0 / 1600.0, **speed_kw)
    # the reference-faithful numerics: multistep1, the direct 49-node sweep
    g["merton_direct"] = dict(model=merton, oracle=oracle,
                              scheme="multistep1",
                              compensator=CompensatorSpec())
    # the Chebyshev compensator alone
    g["merton_cheb"] = dict(model=make_merton_default(jump_sampler="icdf"),
                            oracle=oracle, scheme="multistep1",
                            compensator=cheb64)
    # the global scheme with a trainable, cold Y0
    g["merton_global"] = dict(model=make_merton_default(jump_sampler="icdf"),
                              oracle=oracle, scheme="global",
                              compensator=cheb64)
    # the Variance-Gamma rows, against the Carr-Madan FFT price
    vg = make_vg_default()
    vg_oracle = vg.price_at_origin()
    # the coupled global scheme at N = 240, hidden (64, 64), 4800 steps,
    # the time feature rescaled to the N = 30 range
    g["vg_coupled_direct"] = dict(
        model=dataclasses.replace(make_vg_default(a_lin=0.1),
                                  price_eval="chebyshev", N=240),
        oracle=vg_oracle, scheme="global", seeds=3, peak_lr=3e-3,
        steps=4800, warm_y0=True, time_scale=30.0 / 240.0,
        hidden=(64, 64), **speed_kw)
    # the reference-faithful numerics: exact gamma jumps, the per-path FFT
    # price, the direct 40-node sweep
    g["vg_direct"] = dict(
        model=vg, oracle=vg_oracle, scheme="global",
        compensator=CompensatorSpec(n_hermite=5, n_laguerre=8))
    # the speed configuration: collocated price, icdf subordinator, the
    # hoisted piecewise tables
    g["vg_speed"] = dict(
        model=dataclasses.replace(vg, price_eval="chebyshev",
                                  jump_sampler="icdf"),
        oracle=vg_oracle, scheme="global", **speed_kw)
    # the global scheme at half the coupling, warm Y0
    g["vg_half_coupling"] = dict(
        model=dataclasses.replace(make_vg_default(a_lin=0.05),
                                  price_eval="chebyshev"),
        oracle=vg_oracle, scheme="global", compensator=cheb64, seeds=3,
        peak_lr=3e-3, steps=2400, warm_y0=True)
    registry = {name: {"kind": "gate", "args": args}
                for name, args in g.items()}
    registry["merton_global_extrapolated"] = {
        "kind": "extrapolated",
        "args": dict(
            make_model=lambda a: make_merton_default(
                a_lin=a, jump_sampler="icdf", price_mode="chebyshev"),
            oracle=oracle, compensator=cheb64, seeds=3)}
    registry["vg_global_extrapolated"] = {
        "kind": "extrapolated",
        "args": dict(
            make_model=lambda a: dataclasses.replace(
                make_vg_default(a_lin=a), price_eval="chebyshev"),
            oracle=vg_oracle, compensator=cheb64, seeds=3)}
    return registry


def run_entry(name, entry, **overrides):
    """Run one registry entry with budget-key overrides."""
    args = dict(entry["args"], **overrides)
    if entry["kind"] == "extrapolated":
        return run_extrapolated_gate(name, **args)
    return run_gate(name, **args)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("gates", nargs="*", default=["merton_speed"],
                   help="gate names, or 'all'")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (the default) or 'cpu'")
    p.add_argument("--verbose", action="store_true",
                   help="print each outer epoch's loss, seconds and Y0")
    p.add_argument("--seed", type=int, action="append",
                   help="train only this seed of each gate (repeatable), "
                   "so that a long gate's seeds can run apart; by default "
                   "all of its seeds")
    args = p.parse_args(argv)
    if (torch.device(args.device).type == "cuda"
            and not torch.cuda.is_available()):
        print("convergence_gates: no CUDA device; pass --device cpu to run "
              "on the CPU", file=sys.stderr)
        return 2
    registry = build_registry()
    gates = list(registry) if args.gates == ["all"] else args.gates
    unknown = [g for g in gates if g not in registry]
    if unknown:
        p.error(f"unknown gates {unknown}; known: {sorted(registry)}")
    only = {} if args.seed is None else {"seeds": args.seed}
    records = [run_entry(g, registry[g], device=args.device,
                         verbose=args.verbose, **only) for g in gates]
    return 0 if all(r["pass_1e-3"] for r in records) else 1


if __name__ == "__main__":
    sys.exit(main())
