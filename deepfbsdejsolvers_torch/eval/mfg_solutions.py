"""Fixed-common-noise replay and the Price-of-Anarchy measure.

The intended behaviour of the reference's coupledMFG/MFGSolutions.py and of
the PoA sweep of mainMFGPoA.py:

* draw ONE frozen noise set (common dW0, per-player dW, jump counts dN), so
  that MFG and aggregate-MFC policies, and different players, are compared
  pathwise on the same randomness (mainMFGPoA.py:113-121);
* replay trained policies through the forward system recording every
  process (Q, S, hQ, hS, R, λ, α, α̂, hY, Y), the global scheme rolling the
  BSDEs from its Y0 scalars and the others reading Y from the nets each
  step (``MFGSolver.policy_states``);
* the players' objective functional with its spread, the dynamic price,
  the α target, and PoA = cost_MFG / cost_MFCagg (mainMFGPoA.py:332-334).

The replay runs on the solver's device; the arrays it hands back, and the
objective's arithmetic, are numpy.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from deepfbsdejsolvers_torch.models.mfg_smart_grid import SmartGridMFGModel
from deepfbsdejsolvers_torch.solvers.mfg import MFGSolver


class FrozenNoise(NamedTuple):
    """Pre-drawn noise, tensors of shape (B, N + 1); dW0 and dW include
    the sqrt(dt) scaling."""

    dW0: torch.Tensor
    dW: torch.Tensor
    dN: torch.Tensor


def draw_frozen_noise(model: SmartGridMFGModel, generator: torch.Generator,
                      n_sim: int, n_players: int = 2
                      ) -> Tuple[torch.Tensor, List[torch.Tensor],
                                 torch.Tensor]:
    """The reference's pre-draw on ``generator``'s device: dW0 and each
    player's dW iid N(0, dt) of shape (n_sim, N + 1), then the counts dN
    by ``frozen_counts``, drawn on the same generator."""
    n1, dev = model.N + 1, generator.device
    sdt = math.sqrt(model.dt)
    dw0 = sdt * torch.randn((n_sim, n1), generator=generator, device=dev)
    dws = [sdt * torch.randn((n_sim, n1), generator=generator, device=dev)
           for _ in range(n_players)]
    return dw0, dws, frozen_counts(model, dw0, generator=generator)


def frozen_counts(model: SmartGridMFGModel, dw0: torch.Tensor, jn=None,
                  generator: Optional[torch.Generator] = None
                  ) -> torch.Tensor:
    """dN (n_sim, N + 1) of the pre-draw: column 0 at the initial state,
    column j ≥ 1 after stepping the projected consumption forward under
    dW0 alone, with dW0's column j at step j (mainMFGPoA.py:117-121).
    ``jn`` is the icdf sampler's (u, z), each (N + 1, n_sim); or None, the
    counts then drawn on ``generator`` (``SmartGridMFGModel.counts``)."""
    n_sim = dw0.shape[0]
    with torch.no_grad():
        hq = model.init_state(n_sim, dw0.device).hQ
        hqs = [hq]
        for j in range(1, model.N + 1):
            hq = model.step_projected(j - 1, hq, dw0[:, j])
            hqs.append(hq)
        lam_dt = model.intensity_of(torch.stack(hqs)) * model.dt
        return model.counts(lam_dt, jn, generator).T


@dataclasses.dataclass
class MFGFixedTrajectoryEvaluator:
    """Replays a trained policy on frozen noise (MFGSolutions.py)."""

    solver: MFGSolver
    params: dict
    noise: FrozenNoise

    @property
    def model(self) -> SmartGridMFGModel:
        return self.solver.model

    def simulate_all_processes(self, n_sim: int) -> Dict[str, np.ndarray]:
        """Record every process along the first ``n_sim`` frozen paths:
        numpy arrays (n_sim, N + 1), and meanhQ (N + 1,), alphaTg, t."""
        model, solver = self.model, self.solver
        n = model.N
        n_avail = int(self.noise.dN.shape[0])
        if n_sim > n_avail:
            raise ValueError(
                f"n_sim={n_sim} exceeds the {n_avail} frozen trajectories")
        dev = torch.device(solver.device)
        rows = [torch.as_tensor(a[:n_sim], device=dev).T[:n].contiguous()
                for a in self.noise]
        recs = {k: [] for k in ("Q", "S", "hQ", "hS", "R", "lam",
                                "alpha_hat", "alpha", "hY", "Y")}
        with torch.no_grad():
            exo = solver.exogenous((rows[0], rows[1], rows[2]))
            for i, hs, s, hy, y in solver.policy_states(self.params, exo):
                a_hat, a = solver.controls(exo, i, hy, y)
                for k, v in (("Q", exo.q[i]), ("S", s), ("hQ", exo.hq[i]),
                             ("hS", hs), ("R", exo.r[i]), ("lam", exo.lam[i]),
                             ("alpha_hat", a_hat), ("alpha", a), ("hY", hy),
                             ("Y", y)):
                    recs[k].append(v)
        out = {k: torch.stack(v, 1).cpu().numpy() for k, v in recs.items()}
        out["meanhQ"] = model.mean_hq_table.copy()
        out["alphaTg"] = self.compute_target(n_sim, out["meanhQ"])
        out["t"] = np.arange(n + 1)
        self.trajectories = out
        return out

    def compute_target(self, n_sim: int, mean_hq: np.ndarray) -> np.ndarray:
        """The α-target trajectory (the reference's missing
        ``computeTarget``; MFGSolutions.py:93-97, MFGModel.py:76-79)."""
        if self.model.jump_model == "stochastic":
            return np.broadcast_to(self.model.alpha_target * mean_hq[None, :],
                                   (n_sim, len(mean_hq))).copy()
        return np.full((n_sim, self.model.N + 1), self.model.alpha_target)

    def price(self, pi: float, alpha) -> np.ndarray:
        """Dynamic price p0 + π p1 hQ + (1 − π) p1 (hQ + α)
        (MFGSolutions.py:100-101)."""
        hq = self.trajectories["hQ"]
        return (self.model.p0 + pi * self.model.p1 * hq
                + (1 - pi) * self.model.p1 * (hq + alpha))

    def objective_function(self) -> Tuple[float, float]:
        """The players' cost functional, mean and std over paths
        (MFGSolutions.py:103-111)."""
        m = self.model
        tr = self.trajectories
        Q, S, R = tr["Q"], tr["S"], tr["R"]
        a, a_hat = tr["alpha"], tr["alpha_hat"]
        hq, mean_hq, a_tg = tr["hQ"], tr["meanhQ"][None, :], tr["alphaTg"]
        increment = (
            m.A * 0.5 * a**2 + m.C * 0.5 * S**2 + m.K * 0.5 * (Q + a) ** 2
            + (Q + a) * (m.p0 + m.p1 * m.pi * hq
                         + m.p1 * (1 - m.pi) * (hq + a_hat))
            + (R < m.theta) * (Q - mean_hq + a - a_tg)
            * (m.f0 + m.f1 * (hq - mean_hq + a_hat - a_tg))
        )
        cost = (np.sum(increment * m.dt, axis=1)
                + m.h1 * S[:, -1] + m.h2 * 0.5 * S[:, -1] ** 2)
        return float(np.mean(cost)), float(np.std(cost))


def price_of_anarchy(mfg_eval: MFGFixedTrajectoryEvaluator,
                     mfc_eval: MFGFixedTrajectoryEvaluator,
                     n_sim: int) -> Dict[str, float]:
    """PoA = MFG cost / MFC-aggregate cost with 95% CIs
    (mainMFGPoA.py:322-334)."""
    mfg_eval.simulate_all_processes(n_sim)
    mfc_eval.simulate_all_processes(n_sim)
    mfg_cost, mfg_std = mfg_eval.objective_function()
    mfc_cost, mfc_std = mfc_eval.objective_function()
    half_ci = 1.96 / np.sqrt(n_sim)
    return {
        "mfg_cost": mfg_cost,
        "mfg_ci": half_ci * mfg_std,
        "mfc_cost": mfc_cost,
        "mfc_ci": half_ci * mfc_std,
        "poa": mfg_cost / mfc_cost,
    }
