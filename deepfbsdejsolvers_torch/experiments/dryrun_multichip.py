"""The multi-rank dry run: one data-parallel update of each model family.

    python -m deepfbsdejsolvers_torch.experiments.dryrun_multichip \\
        --ranks K [--device cpu]

spawns K ranks (``parallel/launch.py``; on one card they share it, with
gloo) and runs on each, through ``make_dp_update``, one Adam step of:

1. Merton global at the reference's defaults (hidden (21, 21), N = 50, the
   49-node quadrature) on a (K/2, 2) (data, comp) mesh when K is even and at
   least 4, the compensator's nodes sharded over ``comp`` (B3/B4 sweep each
   rank's slice on the card, ``sweep_impl="pallas"``), else on a data mesh;
2. the Merton speed configuration (collocated price and compensator, icdf
   jumps, hoisted piecewise tables) on a data mesh, and on the card again
   with ``fused_rollout=True`` (B1/B2);
3. the Variance-Gamma speed configuration on a data mesh;
4. the MFG coupled loss (icdf Cox sampler) on a data mesh;

each at 8 paths a data rank.  Every pass's mesh loss must be finite and
the same on every rank; rank 0 prints each with the kernels' launches.
Exit status 0 when all pass, 1 when one fails or a rank fails, 2 without a
card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import sys
from typing import Optional, Sequence

import torch

BATCH = 8


def _counters() -> dict:
    from deepfbsdejsolvers_torch.ops import noise
    from deepfbsdejsolvers_torch.ops import rollout as R
    from deepfbsdejsolvers_torch.ops import sweep as S

    return {"B1": R.b1_forward, "B2": R.b2_backward, "B3": S.b3_forward,
            "B4": S.b4_backward, "J": noise.icdf_jumps}


def _one_update(solver_or_loss, mesh, seed: int, device: str,
                init=None) -> dict:
    """One data-parallel Adam step of a pricing solver's loss (or of a
    given (loss, params) pair): the mesh loss and the launches."""
    from deepfbsdejsolvers_torch.parallel import make_dp_update
    from deepfbsdejsolvers_torch.solvers.train import (
        fold_in, make_adam, make_generator)

    if init is None:
        params = solver_or_loss.init_params(make_generator("cpu", 0, 0))
        loss_fn = solver_or_loss.build_loss(BATCH, mesh)
    else:
        loss_fn, params = solver_or_loss, init
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    update = make_dp_update(loss_fn, make_adam(params, 1e-3), params, mesh)
    loss = float(update(fold_in(make_generator(device, seed),
                                mesh.coord("data"))))
    return {"loss": loss,
            "launches": {k: fn.launches for k, fn in counters.items()}}


def dryrun_rank(rank: int, n_ranks: int, device: str) -> dict:
    """The four passes on this rank: {pass: {"loss", "launches"}}."""
    from deepfbsdejsolvers_torch.models.merton import make_merton_default
    from deepfbsdejsolvers_torch.models.mfg_smart_grid import (
        make_mfg_default)
    from deepfbsdejsolvers_torch.models.variance_gamma import make_vg_default
    from deepfbsdejsolvers_torch.ops.compensator import CompensatorSpec
    from deepfbsdejsolvers_torch.parallel import make_mesh
    from deepfbsdejsolvers_torch.solvers.mfg import MFGSolver
    from deepfbsdejsolvers_torch.solvers.pricing import PricingSolver
    from deepfbsdejsolvers_torch.solvers.train import make_generator

    card = torch.device(device).type == "cuda"
    out = {}
    n_comp = 2 if n_ranks % 2 == 0 and n_ranks >= 4 else 1
    if n_comp > 1:
        mesh = make_mesh((n_ranks // 2, 2), ("data", "comp"), device=device)
        shard = dict(comp_axis="comp", comp_shards=2)
    else:
        mesh, shard = make_mesh(device=device), {}
    solver = PricingSolver(make_merton_default(), "global", device=device,
                           sweep_impl="pallas" if card else "xla", **shard)
    out["merton"] = _one_update(solver, mesh, 1, device)
    out["merton"]["mesh"] = mesh.shape

    mesh = make_mesh(device=device)
    speed = dict(compensator=CompensatorSpec(x_interp="chebyshev", n_cheb=64),
                 hoist=True, hoist_interp="piecewise", device=device)
    model = make_merton_default(jump_sampler="icdf", price_mode="chebyshev")
    out["speed"] = _one_update(PricingSolver(model, "global", **speed), mesh,
                               2, device)
    if card:
        out["speed_fused"] = _one_update(
            PricingSolver(model, "global", fused_rollout=True, **speed),
            mesh, 2, device)
    vg = dataclasses.replace(make_vg_default(jump_sampler="icdf"),
                             price_eval="chebyshev")
    out["vg_speed"] = _one_update(PricingSolver(vg, "global", **speed), mesh,
                                  3, device)
    mfg = MFGSolver(dataclasses.replace(make_mfg_default(nb_days=1),
                                        jump_sampler="icdf"), "global",
                    device=device)
    out["mfg"] = _one_update(mfg.build_losses(BATCH)["coupled"], mesh, 4,
                             device, init=mfg.init_params(
                                 make_generator("cpu", 0, 0)))
    if rank == 0:
        for name, res in out.items():
            print(f"dryrun {name}: mesh loss {res['loss']:.6f}, launches "
                  f"{res['launches']}", flush=True)
    return out


def run(n_ranks: int, device: str = "cuda", timeout: float = 600.0) -> dict:
    """Spawn the ranks, check every pass, and return rank 0's results and
    every rank's launches ({"passes": ..., "launches": [...]}); raises
    RuntimeError if a rank fails or a pass's loss is not finite or not the
    same on every rank."""
    from deepfbsdejsolvers_torch.parallel.launch import run_ranks

    ranks = run_ranks(dryrun_rank, n_ranks, n_ranks, str(device),
                      device=device, timeout=timeout)
    for name, res in ranks[0].items():
        losses = [r[name]["loss"] for r in ranks]
        if not all(math.isfinite(v) for v in losses):
            raise RuntimeError(f"dryrun {name}: non-finite loss {losses}")
        if len(set(losses)) != 1:
            raise RuntimeError(f"dryrun {name}: ranks disagree on the mesh "
                               f"loss {losses}")
    return {"passes": ranks[0],
            "launches": [{k: v["launches"] for k, v in r.items()}
                         for r in ranks]}


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m deepfbsdejsolvers_torch.experiments.dryrun_multichip",
        description="one data-parallel update of each model family on K "
                    "ranks")
    p.add_argument("--ranks", type=int, default=4)
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (the default; the ranks share the card "
                        "unless there is one for each) or 'cpu'")
    p.add_argument("--timeout", type=float, default=600.0,
                   help="seconds before a rank that has not finished fails "
                        "the run")
    args = p.parse_args(argv)
    if (torch.device(args.device).type == "cuda"
            and not torch.cuda.is_available()):
        print("dryrun_multichip: no CUDA device; pass --device cpu",
              file=sys.stderr)
        return 2
    try:
        run(args.ranks, args.device, args.timeout)
    except RuntimeError as e:
        print(f"dryrun_multichip: FAIL: {e}", file=sys.stderr)
        return 1
    print(f"dryrun_multichip OK: {args.ranks} ranks")
    return 0


if __name__ == "__main__":
    sys.exit(main())
