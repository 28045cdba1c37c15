"""The accuracy gates of the port, on the card.

    python -m deepfbsdejsolvers_torch.experiments.convergence_gates \\
        merton_speed vg_speed mfg_lq_global [--device cuda]

Each gate trains a solver on its registered budget (Adam under a
cosine-decayed learning rate, peak ``peak_lr`` over ``steps`` updates,
batch 8192, ``seeds`` independent runs) and reports |Y0 − oracle| against
the model's own price A(0, x0): the closed-form Merton price 0.271457, or
the Variance-Gamma Carr-Madan FFT price 0.133141.  A gate passes when the
largest error over its seeds is at most 1e-3.  The registry
(``build_registry``) holds the JAX package's gate script's ten Merton rows
and five Variance-Gamma rows with the same configuration and budget keys,
and its six MFG rows, so a CPU test can train every row at a small budget
and check that the rows have not drifted.

The MFG rows: five ``mfg_lq_*`` rows train one scheme each (batch 4096,
cosine peak 6e-3, 3 seeds) on the linear-quadratic corner of the
comparison model (f0 = f1 = 0, the icdf Cox sampler), where the exact
(Y0_hat, Y0) is known (``eval/mfg_lq_oracle.py``, −48.320138), and pass
when the larger relative error of the pair, over the seeds, is within the
row's bar: 1e-3 for the warm-started global scheme (4800 steps), 2.5e-2 for
the multistep pair and 4e-2 for the sumlocal pair (2400 steps), which pin
the feedback schemes' low bias in the JAX package's TPU record.
``mfg_consensus`` trains the warm-started global scheme and sumlocal on the
default comparison model (f1 = 1e4) and passes when their Y0_hat agree
within 3.0 and their frozen-noise expected costs within 0.6.

Seeds are taken as in that script: the nets from ``seed``, the warm start
of Y0 from 9000 + seed, the training noise from 1 + 100·seed, each through
``make_generator``.  torch's Philox draws are not JAX's threefry draws, so
the per-seed numbers differ from the JAX package's; the bars are what
carry over.  Each gate prints one JSON record, the JAX script's keys plus
the seeds it trained, the device it ran on and its seconds.  ``--seed``
trains only the seeds named, so that a gate too long for one run can be
run a seed at a time.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np
import torch

from deepfbsdejsolvers_torch.eval.mfg_lq_oracle import solve_lq
from deepfbsdejsolvers_torch.models.merton import make_merton_default
from deepfbsdejsolvers_torch.models.mfg_smart_grid import make_mfg_default
from deepfbsdejsolvers_torch.models.variance_gamma import make_vg_default
from deepfbsdejsolvers_torch.ops.compensator import CompensatorSpec
from deepfbsdejsolvers_torch.solvers.mfg import MFGSolver
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


def _fit_mfg(solver, seed, batch, peak_lr, steps, warm_y0, tail, warm_batch,
             device, verbose):
    """One cosine-decayed coupled fit of an MFGSolver from ``seed``, seeded
    as ``_fit_y0``; returns the (Y0_hat, Y0) means over the last
    max(tail // 4, 2) outer epochs and the trained params."""
    params = solver.init_params(make_generator("cpu", seed))
    if warm_y0 and solver.scheme == "global":
        params = solver.warm_start_y0(
            params, make_generator(device, 9000 + seed), batch=warm_batch)
    num_epoch = min(400, steps)
    res = fit(loss_fn=solver.build_losses(batch)["coupled"], params=params,
              seed=1 + 100 * seed,
              lrate=cosine_decay_schedule(peak_lr, steps),
              num_epoch=num_epoch, num_epoch_ext=steps // num_epoch,
              y0_fn=solver.y0_estimates, verbose=verbose)
    window = res.y0_history[-max(tail // 4, 2):]
    return (float(np.mean([y[0] for y in window])),
            float(np.mean([y[1] for y in window])), res.params)


def run_mfg_lq_gate(name, model, scheme, batch=4096, peak_lr=6e-3,
                    steps=4800, seeds=1, tail=12, warm_y0=False,
                    rel_gate=1e-3, warm_batch=16384, device="cuda",
                    verbose=False, **solver_kw):
    """Train ``scheme`` on an f0 = f1 = 0 model and report the larger of
    |Y0_hat − oracle| and |Y0 − oracle| relative to |oracle| per seed,
    against the exact linear-quadratic oracle; ``seeds`` is a count or the
    seed numbers."""
    t0 = time.perf_counter()
    oracle = solve_lq(model)
    solver = MFGSolver(model, scheme, device=device, **solver_kw)
    scale = abs(oracle.y0_hat)
    runs = _seed_list(seeds)
    y0s, errs = [], []
    for seed in runs:
        y0_hat, y0, _ = _fit_mfg(solver, seed, batch, peak_lr, steps,
                                 warm_y0, tail, warm_batch, device, verbose)
        y0s.append((y0_hat, y0))
        errs.append(max(abs(y0_hat - oracle.y0_hat),
                        abs(y0 - oracle.y0)) / scale)
    record = {"gate": name, "scheme": scheme, "seeds": runs,
              "y0_pairs": y0s[0] if seeds == 1 else y0s,
              "oracle": oracle.y0_hat, "rel_error": max(errs),
              "mean_rel_error": float(np.mean(errs)),
              # cold nets read ~0 at init, a relative error of ~1; the
              # smoke tier asserts progress against this
              "init_rel_error": 1.0,
              f"pass_{rel_gate:g}": max(errs) <= rel_gate,
              "device": _device_name(device),
              "seconds": time.perf_counter() - t0}
    print(json.dumps(record), flush=True)
    return record


def run_mfg_consensus_gate(name, model, schemes=("global", "sumlocal"),
                           batch=512, peak_lr=3e-3, steps=6000, tail=12,
                           band_tol=3.0, cost_tol=0.6, cost_batch=65536,
                           seeds=1, warm_batch=16384, device="cuda",
                           verbose=False):
    """Train the warm-started global scheme and a feedback scheme on the
    default comparison model and check that (a) their Y0_hat agree within
    ``band_tol`` and (b) their expected costs under ``simulate_global_err``
    on one shared draw (the generator of seed 777) agree within
    ``cost_tol``."""
    t0 = time.perf_counter()
    runs = _seed_list(seeds)
    results = {}
    for seed in runs:
        for scheme in schemes:
            solver = MFGSolver(model, scheme, device=device)
            y0_hat, y0, params = _fit_mfg(
                solver, seed, batch, peak_lr, steps,
                warm_y0=(scheme == "global"), tail=tail,
                warm_batch=warm_batch, device=device, verbose=verbose)
            cost_hat, cost, _ = solver.simulate_global_err(
                params, make_generator(device, 777), cost_batch)
            results.setdefault(scheme, []).append(
                {"y0_hat": y0_hat, "y0": y0, "cost_hat": float(cost_hat),
                 "cost": float(cost)})
    spread = {key: max(abs(results[a][s][key] - results[b][s][key])
                       for s in range(len(runs))
                       for a in schemes for b in schemes)
              for key in ("y0_hat", "cost_hat")}
    record = {"gate": name, "seeds": runs, "per_scheme": results,
              "y0_hat_spread": spread["y0_hat"],
              "cost_hat_spread": spread["cost_hat"],
              "band_tol": band_tol, "cost_tol": cost_tol,
              "pass": (spread["y0_hat"] <= band_tol
                       and spread["cost_hat"] <= cost_tol),
              "device": _device_name(device),
              "seconds": time.perf_counter() - t0}
    print(json.dumps(record), flush=True)
    return record


def passed(record) -> bool:
    """Whether a gate's record passes its bar (its "pass…" keys)."""
    return all(v for k, v in record.items() if k.startswith("pass"))


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
    # the MFG rows: the linear-quadratic corner (f0 = f1 = 0) of the
    # comparison model with the icdf Cox sampler, against the exact oracle
    mfg_lq = dataclasses.replace(make_mfg_default(f0=0.0, f1=0.0),
                                 jump_sampler="icdf")
    lq_budget = {
        "global": dict(steps=4800, rel_gate=1e-3, warm_y0=True),
        "multistep": dict(steps=2400, rel_gate=2.5e-2),
        "multistep_reg": dict(steps=2400, rel_gate=2.5e-2),
        "sumlocal": dict(steps=2400, rel_gate=4e-2),
        "sumlocal_reg": dict(steps=2400, rel_gate=4e-2),
    }
    for scheme, budget in lq_budget.items():
        registry[f"mfg_lq_{scheme}"] = {
            "kind": "mfg_lq",
            "args": dict(model=mfg_lq, scheme=scheme, seeds=3, batch=4096,
                         peak_lr=6e-3, **budget)}
    # the default comparison model (f1 = 1e4): cross-scheme consensus
    registry["mfg_consensus"] = {
        "kind": "mfg_consensus",
        "args": dict(model=dataclasses.replace(make_mfg_default(),
                                               jump_sampler="icdf"))}
    return registry


def run_entry(name, entry, **overrides):
    """Run one registry entry with budget-key overrides."""
    args = dict(entry["args"], **overrides)
    runner = {"extrapolated": run_extrapolated_gate,
              "mfg_lq": run_mfg_lq_gate,
              "mfg_consensus": run_mfg_consensus_gate}.get(entry["kind"],
                                                           run_gate)
    return runner(name, **args)


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
    return 0 if all(passed(r) for r in records) else 1


if __name__ == "__main__":
    sys.exit(main())
