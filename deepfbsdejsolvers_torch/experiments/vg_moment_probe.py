"""The Variance-Gamma forward walk's f32 exp bias, measured on the card.

    python -m deepfbsdejsolvers_torch.experiments.vg_moment_probe \\
        [--log2-draws 28] [--log2-paths 24] [--device cuda]

For each jump sampler (exact, icdf) and each grid (N = 30 and N = 240,
the subordinator's shape dt/κ = 1/3 and 1/24) it measures

* the realized exponential moment of one increment: the relative defect
  of E[e^J] against e^{ω·dt}, which the martingale correction ω makes
  exact, over 2^log2-draws draws (in chunks of 2^24, each chunk's f32 mean
  of expm1(J), so that no summand is near 1, and the chunk means summed in
  float64), with its standard error; also E[G] against dt;
* the uncoupled forward walk's E[X_N] against x0·e^{rT}, over
  2^log2-paths paths, with the walk's update written two ways on the same
  draws: ``mul_exp`` (x + x·expm1_acc(u), the port's) and a plain
  x·exp(u).  The two share every draw, so their difference is measured
  far below the standard error of either.

A relative defect ε of E[e^J] compounds over the walk as E[X_N] =
x0·e^{rT}·(1 + ε)^N; an exp that is biased near 0 by δ per call adds
N·δ to the plain update's defect, which ``mul_exp`` removes.  One JSON
record per (sampler, N), then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import subprocess
import sys

import torch

CHUNK = 2**24


def _moments(model, gen, draws: int, chunk: int) -> dict:
    """The increment's exponential moment and the subordinator's mean,
    over ``draws`` draws in chunks of ``chunk``."""
    dt, n = model.dt, max(1, draws // chunk)
    lam = model.theta + 0.5 * model.sigJ**2     # E[e^J | G] = e^{λG}
    s_ej = s_ej2 = s_g = s_eg = 0.0
    for _ in range(n):
        g = model.sample_gamma(gen, (chunk,))
        z = torch.randn((chunk,), generator=gen, device=gen.device)
        em = torch.expm1(model.theta * g + model.sigJ * torch.sqrt(g) * z)
        s_ej += float(em.mean())
        s_ej2 += float((em * em).mean())
        s_g += float(g.mean())
        s_eg += float(torch.expm1(lam * g).mean())
    m_ej, m_g, m_eg = s_ej / n, s_g / n, s_eg / n
    target = math.expm1(model.correction * dt)
    se = math.sqrt(max(s_ej2 / n - m_ej**2, 0.0) / (n * chunk))
    scale = 1.0 + target                         # e^{ω dt}
    return {"draws": n * chunk,
            "E_expJ_defect_rel": (m_ej - target) / scale,
            "se_rel": se / scale,
            "sigmas": (m_ej - target) / se if se else 0.0,
            "E_expG_defect_rel": (m_eg - target) / scale,
            "E_G_defect_rel": m_g / dt - 1.0}


def _walk(model, gen, paths: int, chunk: int) -> dict:
    """E[X_N] of the uncoupled walk under both updates, on shared draws,
    ``chunk`` paths at a time."""
    from deepfbsdejsolvers_torch.ops.numerics import mul_exp

    n_chunks, batch = max(1, paths // chunk), min(paths, chunk)
    drift = (model.r - model.correction) * model.dt
    target = model.x0 * math.exp(model.r * model.T)
    sums = {"mul_exp": 0.0, "exp": 0.0, "diff": 0.0, "diff2": 0.0,
            "x2": 0.0}
    for _ in range(n_chunks):
        x_m = torch.full((batch,), model.x0, device=gen.device)
        x_e = x_m.clone()
        for _ in range(model.N):
            u = drift + model.sample_jumps(gen, (batch,))
            x_m = mul_exp(x_m, u)
            x_e = x_e * torch.exp(u)
        d = (x_e - x_m).double()
        sums["mul_exp"] += float(x_m.double().mean())
        sums["exp"] += float(x_e.double().mean())
        sums["diff"] += float(d.mean())
        sums["diff2"] += float((d * d).mean())
        sums["x2"] += float((x_m.double() ** 2).mean())
    k = n_chunks
    mean = {key: v / k for key, v in sums.items()}
    n_all = k * batch
    se_x = math.sqrt(max(mean["x2"] - mean["mul_exp"]**2, 0.0) / n_all)
    se_d = math.sqrt(max(mean["diff2"] - mean["diff"]**2, 0.0) / n_all)
    return {"paths": n_all,
            "mart_defect_rel_mul_exp": mean["mul_exp"] / target - 1.0,
            "mart_defect_rel_exp": mean["exp"] / target - 1.0,
            "se_rel": se_x / target,
            "exp_minus_mul_exp_rel": mean["diff"] / target,
            "se_diff_rel": se_d / target}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--log2-draws", type=int, default=28)
    p.add_argument("--log2-paths", type=int, default=24)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if (torch.device(args.device).type == "cuda"
            and not torch.cuda.is_available()):
        print("vg_moment_probe: no CUDA device; pass --device cpu",
              file=sys.stderr)
        return 2
    from deepfbsdejsolvers_torch.models.variance_gamma import make_vg_default
    from deepfbsdejsolvers_torch.solvers.train import make_generator

    chunk = min(CHUNK, 2**args.log2_draws, 2**args.log2_paths)
    for sampler in ("exact", "icdf"):
        for n in (30, 240):
            model = dataclasses.replace(
                make_vg_default(a_lin=0.0, jump_sampler=sampler), N=n)
            gen = make_generator(args.device, 9000 + n,
                                 sampler == "icdf")
            rec = {"sampler": sampler, "N": n,
                   "shape": model.dt / model.kappa,
                   "moment": _moments(model, gen, 2**args.log2_draws,
                                      chunk),
                   "walk": _walk(model, gen, 2**args.log2_paths, chunk)}
            print(json.dumps(rec), flush=True)
    if torch.device(args.device).type == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60).stdout.strip()
        print(smi or "nvidia-smi: no output")
    return 0


if __name__ == "__main__":
    sys.exit(main())
