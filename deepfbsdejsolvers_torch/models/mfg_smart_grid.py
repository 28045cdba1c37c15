"""Coupled McKean-Vlasov FBSDE for electricity demand response (smart grids).

Consumption Q (and its projection hQ on the common noise) mean-reverts to a
daily profile ``q_aver`` under OU dynamics with common noise σ0·dW0 and
idiosyncratic σ·dW; the cumulative deviation S (and hS) integrates the
feedback controls; the clock-since-jump R resets on doubly stochastic (Cox)
Poisson jumps of intensity λ = β(e^{α·hQ} − 1); the closed-form Pontryagin
controls α̂(hY), α(hY, Y) gate their tariff terms on R ≤ θ; the driver is
f(U) = C·U and the terminal g(X) = h1 + h2·X.  ``coeff_equi`` switches the
MFG (1) and aggregate-MFC (2) price internalization.

The state is an explicit ``MFGState`` whose step index ``i`` is a Python
int: the per-step scalars (the profile ``q_aver[i]``, the mean projection
``mean_hq[i]``, the time feature i·dt) are rows of the device tables
(``tables``), read without a host sync.  The host tables are built in
float64 and stored in float32, as the JAX package stores them.

hQ, Q and R never see a control: hQ and Q move with the profile and the
noise, R with the jump counts, which depend on hQ only.  So every control
term that depends on (hQ, Q, R) alone can be tabulated for all steps before
a rollout (``hat_terms``, ``full_terms``); ``calpha_hat`` and ``calpha``
evaluate the same terms at one step, so both routes compute the same
numbers in the same order.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch


class MFGState(NamedTuple):
    """The forward state at step ``i`` (a Python int); the rest (B,)."""

    i: int
    hQ: torch.Tensor   # projected consumption
    Q: torch.Tensor    # consumption
    R: torch.Tensor    # time since the last jump
    hS: torch.Tensor   # projected cumulative deviation
    S: torch.Tensor    # cumulative deviation


# The 48-point average daily consumption profile (mainMFGComparison.py:83-87).
Q_AVER_ONE_DAY = np.array([
    0.26759617, 0.24771933, 0.23588383, 0.221369, 0.21174, 0.2047625,
    0.20651067, 0.20098083, 0.20826067, 0.22095067, 0.24346833, 0.27283267,
    0.3382265, 0.42920433, 0.4875495, 0.50948433, 0.487712, 0.4537295,
    0.40911717, 0.3728925, 0.347346, 0.3419715, 0.32684, 0.320009,
    0.32065767, 0.32586567, 0.31492483, 0.31607417, 0.30411783, 0.29950567,
    0.307519, 0.33259367, 0.375465, 0.45608333, 0.599178, 0.70970583,
    0.7364855, 0.736731, 0.70612667, 0.67284583, 0.66692767, 0.64925583,
    0.604485, 0.55684567, 0.515597, 0.45097333, 0.3822625, 0.31841833,
])


def daily_profile(nb_days: int = 2, raf_coef: int = 1) -> np.ndarray:
    """q_aver as the reference's mains build it (mainMFGComparison.py:88-90)."""
    q = np.concatenate([Q_AVER_ONE_DAY] * nb_days, axis=-1)
    return np.tile(q[:, None], [1, raf_coef]).flatten()


class HatTerms(NamedTuple):
    """The parts of α̂ = nk·((c + hY) + g) that hQ and R fix."""

    gate: torch.Tensor   # 1 where R ≤ θ, else 0
    nk: torch.Tensor     # −1/k_θ
    c: torch.Tensor      # p0 + π·p1·hQ + ((1 − π)·ce·p1 + K)·hQ
    g: torch.Tensor      # (f0 + ce·f1·(hQ − mean_hq − target))·gate


class FullTerms(NamedTuple):
    """The parts of α that (hQ, Q) fix."""

    e: torch.Tensor      # K·Q + p0 + π·p1·hQ
    hm: torch.Tensor     # hQ − mean_hq


@dataclasses.dataclass(frozen=True)
class SmartGridMFGModel:
    """Pure-functional MFG model; N = len(q_aver) − 1, dt = T/N."""

    T: float
    q_aver: np.ndarray
    R0: float
    jump_factor: float
    alpha: float
    beta: float
    coeff_ou: float
    A: float
    K: float
    pi: float
    p0: float
    p1: float
    f0: float
    f1: float
    theta: float
    C: float
    S0: float
    h1: float
    h2: float
    sig0: float
    sig: float
    alpha_target: float
    jump_model: str = "stochastic"   # 'stochastic' (Cox) | 'constant'
    coeff_equi: float = 1.0          # 1 = MFG, 2 = aggregate MFC
    # "exact" draws dN with torch.poisson; "icdf" inverts the per-path
    # Poisson CDF by the pmf recurrence p_k = p_{k−1}·λdt/k where λ·dt ≤
    # ``icdf_switch`` (depth set at construction so the tail mass at the
    # switch is below ``icdf_tail_tol``) and takes round(λdt + √λdt·Z)⁺
    # above it, where the f32 seed e^{−λdt} would underflow.
    jump_sampler: str = "exact"
    icdf_k_max: int = 12
    icdf_switch: float = 32.0
    icdf_tail_tol: float = 1e-6

    def __post_init__(self):
        if self.jump_sampler not in ("exact", "icdf"):
            raise ValueError("jump_sampler must be exact|icdf, got "
                             f"{self.jump_sampler!r}")
        if self.jump_model not in ("stochastic", "constant"):
            raise ValueError("jump_model must be stochastic|constant, got "
                             f"{self.jump_model!r}")
        q = np.asarray(self.q_aver, np.float64)
        n = len(q) - 1
        dt = self.T / n
        # meanhQ(i) = e^{−c i dt} q[0] + c Σ_{j<i} q[j] e^{c (j−i) dt} dt
        c = self.coeff_ou
        mean_hq = np.empty(n + 1)
        mean_hq[0] = q[0]
        j = np.arange(n, dtype=np.float64)
        for i in range(1, n + 1):
            jj = j[:i]
            mean_hq[i] = (np.exp(-c * i * dt) * q[0]
                          + c * np.sum(q[:i] * np.exp(c * (jj - i) * dt)) * dt)
        # icdf depth: the smallest k whose Poisson tail mass at the switch
        # intensity is below the tolerance.  The seed e^{−λdt} is an f32
        # denormal past λdt ≈ 87, so the switch stays at 80 or below.
        lam_dt_bound = max(float(self.icdf_switch), 0.0)
        if lam_dt_bound > 80.0:
            raise ValueError(
                f"icdf_switch={self.icdf_switch} exceeds the f32 exp(-λ·dt) "
                "underflow limit (~80): the pmf recurrence seed would "
                "underflow to 0 below the CLT switch. Use icdf_switch <= 80.")
        p = np.exp(-lam_dt_bound)
        cdf, k = p, 0
        while cdf < 1.0 - self.icdf_tail_tol and k < 1024:
            k += 1
            p *= lam_dt_bound / k
            cdf += p
        if cdf < 1.0 - self.icdf_tail_tol:
            raise ValueError(
                f"icdf recurrence depth hit the 1024 cap before reaching "
                f"tail tolerance {self.icdf_tail_tol} at icdf_switch="
                f"{self.icdf_switch} — lower the switch or loosen the tol.")
        mean32 = mean_hq.astype(np.float32)
        if self.jump_model == "stochastic":
            target = np.float32(self.alpha_target) * mean32
        else:
            target = np.full(n + 1, self.alpha_target, np.float32)
        host = {"q_aver": q.astype(np.float32), "mean_hq": mean32,
                "target": target,
                "t": np.arange(n + 1, dtype=np.float32) * np.float32(dt)}
        object.__setattr__(self, "_N", int(n))
        object.__setattr__(self, "_dt", float(dt))
        object.__setattr__(self, "_host", host)
        object.__setattr__(self, "_dev", {})
        object.__setattr__(self, "_icdf_k_eff", max(int(self.icdf_k_max), k))

    # ---- scalars and tables ------------------------------------------------
    @property
    def N(self) -> int:
        return self._N

    @property
    def dt(self) -> float:
        return self._dt

    @property
    def mean_hq_table(self) -> np.ndarray:
        """meanhQ(i), i = 0…N, float32 on the host."""
        return self._host["mean_hq"]

    def tables(self, device) -> dict:
        """The (N + 1,) float32 tables q_aver, mean_hq, target (the α
        target per step) and t (i·dt) on ``device``, copied on first use."""
        device = torch.device(device)
        if device not in self._dev:
            self._dev[device] = {k: torch.as_tensor(v, device=device)
                                 for k, v in self._host.items()}
        return self._dev[device]

    # ---- state -----------------------------------------------------------
    def init_state(self, batch: int, device="cuda") -> MFGState:
        """Every path at the deterministic initial state."""
        def full(v):
            return torch.full((batch,), float(v), dtype=torch.float32,
                              device=device)
        q0 = self._host["q_aver"][0]
        return MFGState(i=0, hQ=full(q0), Q=full(q0), R=full(self.R0),
                        hS=full(self.S0), S=full(self.S0))

    # ---- jumps -----------------------------------------------------------
    def intensity_of(self, hq: torch.Tensor) -> torch.Tensor:
        """Cox intensity β(e^{α·hQ} − 1), or the constant jump factor."""
        if self.jump_model == "stochastic":
            return self.beta * (torch.exp(self.alpha * hq) - 1.0)
        return torch.full_like(hq, self.jump_factor)

    def intensity(self, state: MFGState) -> torch.Tensor:
        return self.intensity_of(state.hQ)

    def sample_dn(self, u: torch.Tensor, z: torch.Tensor,
                  lam_dt: torch.Tensor) -> torch.Tensor:
        """icdf-mode counts from pre-drawn uniforms ``u`` and normals ``z``
        at rates ``lam_dt`` of any one shape: the pmf recurrence below the
        switch (λ·dt clipped there so the seed never underflows; those
        paths take the CLT branch), round(max(λdt + √λdt·z, 0)) above."""
        lam_rec = torch.clamp(lam_dt, max=self.icdf_switch)
        p = torch.exp(-lam_rec)               # P(N = 0)
        cdf = p
        dn = torch.zeros_like(lam_dt)
        for k in range(1, self._icdf_k_eff + 1):
            dn = dn + (u > cdf)               # one count per CDF level passed
            p = p * lam_rec / k
            cdf = cdf + p
        dn_big = torch.round(torch.clamp(lam_dt + torch.sqrt(lam_dt) * z,
                                         min=0.0))
        return torch.where(lam_dt > self.icdf_switch, dn_big, dn)

    def sample_dN_from(self, u: torch.Tensor, z: torch.Tensor,
                       state: MFGState) -> Tuple[torch.Tensor, torch.Tensor]:
        """(dN, λ·dt) at ``state`` from pre-drawn ``u``, ``z`` (icdf law)."""
        lam_dt = self.intensity(state) * self._dt
        return self.sample_dn(u, z, lam_dt), lam_dt

    def counts(self, lam_dt: torch.Tensor, jn=None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """dN at the rates ``lam_dt``: from the icdf sampler's pre-drawn
        ``jn = (u, z)``; ``jn`` itself when it holds the counts; else drawn
        on ``generator``, by the icdf law on fresh (u, z) or by
        ``torch.poisson``."""
        if isinstance(jn, tuple):
            return self.sample_dn(jn[0], jn[1], lam_dt)
        if jn is not None:
            return jn
        if self.jump_sampler == "icdf":
            return self.sample_dn(
                torch.rand(lam_dt.shape, generator=generator,
                           device=lam_dt.device),
                torch.randn(lam_dt.shape, generator=generator,
                            device=lam_dt.device), lam_dt)
        return torch.poisson(lam_dt, generator=generator)

    def sample_dN(self, generator: torch.Generator,
                  state: MFGState) -> Tuple[torch.Tensor, torch.Tensor]:
        """(dN, λ·dt) at ``state``, drawn on ``generator``."""
        lam_dt = self.intensity(state) * self._dt
        return self.counts(lam_dt, generator=generator), lam_dt

    # ---- controls ----------------------------------------------------------
    def hat_terms(self, hq: torch.Tensor, r: torch.Tensor, mean_hq,
                  target) -> HatTerms:
        """The terms of α̂ fixed by hQ, R and the step's mean_hq and
        target (scalars, or columns broadcasting against hQ)."""
        gate = (r <= self.theta).to(hq.dtype)
        k_theta = (self.A + (1 - self.pi) * self.coeff_equi * self.p1
                   + self.K + self.coeff_equi * self.f1 * gate)
        c = (self.p0 + self.pi * self.p1 * hq
             + ((1 - self.pi) * self.coeff_equi * self.p1 + self.K) * hq)
        g = (self.f0 + self.coeff_equi * self.f1
             * (hq - mean_hq - target)) * gate
        return HatTerms(gate, -(1.0 / k_theta), c, g)

    def full_terms(self, hq: torch.Tensor, q: torch.Tensor,
                   mean_hq) -> FullTerms:
        """The terms of α fixed by hQ, Q and the step's mean_hq."""
        return FullTerms(self.K * q + self.p0 + self.pi * self.p1 * hq,
                         hq - mean_hq)

    @staticmethod
    def alpha_hat_from(ht: HatTerms, hy: torch.Tensor) -> torch.Tensor:
        """Projected Pontryagin control α̂(hY) (MFGModel.py:83-85)."""
        return ht.nk * (ht.c + hy + ht.g)

    def alpha_from(self, ht: HatTerms, ft: FullTerms, hq: torch.Tensor,
                   target, a_hat: torch.Tensor,
                   y: torch.Tensor) -> torch.Tensor:
        """Full control α(hY, Y) (MFGModel.py:87-89) given α̂."""
        s = (ft.e + (1 - self.pi) * self.coeff_equi * self.p1 * (hq + a_hat)
             + y)
        w = self.f0 + self.coeff_equi * self.f1 * (ft.hm + a_hat - target)
        return -(1.0 / (self.A + self.K)) * (s + w * ht.gate)

    def _step_scalars(self, state: MFGState):
        tb = self.tables(state.hQ.device)
        return tb["mean_hq"][state.i], tb["target"][state.i]

    def calpha_hat(self, state: MFGState, hy: torch.Tensor) -> torch.Tensor:
        m, tg = self._step_scalars(state)
        return self.alpha_hat_from(self.hat_terms(state.hQ, state.R, m, tg),
                                   hy)

    def calpha(self, state: MFGState, hy: torch.Tensor,
               y: torch.Tensor) -> torch.Tensor:
        m, tg = self._step_scalars(state)
        ht = self.hat_terms(state.hQ, state.R, m, tg)
        a_hat = self.alpha_hat_from(ht, hy)
        return self.alpha_from(ht, self.full_terms(state.hQ, state.Q, m),
                               state.hQ, tg, a_hat, y)

    # ---- dynamics ------------------------------------------------------------
    def _reverted(self, i: int, x: torch.Tensor) -> torch.Tensor:
        """x + c·(q_aver[i + 1] − x)·dt: the OU drift step of step i."""
        q_next = self.tables(x.device)["q_aver"][i + 1]
        return x + self.coeff_ou * (q_next - x) * self._dt

    def step_projected(self, i: int, hq: torch.Tensor,
                       dw0: torch.Tensor) -> torch.Tensor:
        """hQ at step i + 1: mean reversion toward q_aver[i + 1] + σ0·dW0."""
        return self._reverted(i, hq) + self.sig0 * dw0

    def step_consumption(self, i: int, hq: torch.Tensor, q: torch.Tensor,
                         dw0: torch.Tensor, dw: torch.Tensor):
        """(hQ, Q) at step i + 1: mean reversion toward q_aver[i + 1], with
        σ0·dW0 for both and σ·dW for Q."""
        common = self.sig0 * dw0
        return (self._reverted(i, hq) + common,
                self._reverted(i, q) + common + self.sig * dw)

    def step_clock(self, r: torch.Tensor, dn: torch.Tensor) -> torch.Tensor:
        """R at the next step: + dt, reset to dt after a jump."""
        return r + self._dt - torch.where(dn > 0, r, 0.0)

    def step(self, state: MFGState, dW0: torch.Tensor, dW: torch.Tensor,
             dN: torch.Tensor, hY: torch.Tensor, Y: torch.Tensor) -> MFGState:
        """One forward step (MFGModel.py:58-71): controls and gates use the
        pre-step state; hQ/Q mean-revert toward q_aver at the new index."""
        hS = state.hS + self.calpha_hat(state, hY) * self._dt
        S = state.S + self.calpha(state, hY, Y) * self._dt
        R = self.step_clock(state.R, dN)
        hQ, Q = self.step_consumption(state.i, state.hQ, state.Q, dW0, dW)
        return MFGState(i=state.i + 1, hQ=hQ, Q=Q, R=R, hS=hS, S=S)

    # ---- BSDE pieces ---------------------------------------------------------
    def f(self, u: torch.Tensor) -> torch.Tensor:
        """Driver f(U) = C·U."""
        return u * self.C

    def g(self, x: torch.Tensor) -> torch.Tensor:
        """Terminal g(X) = h1 + h2·X."""
        return self.h1 + self.h2 * x

    # ---- net features --------------------------------------------------------
    def _t(self, state: MFGState) -> torch.Tensor:
        t = self.tables(state.hQ.device)["t"][state.i]
        return t.expand(state.hQ.shape)

    def projected_features(self, state: MFGState) -> torch.Tensor:
        """(t, hQ, hS, R) stacked: the hat-net input."""
        return torch.stack([self._t(state), state.hQ, state.hS, state.R], -1)

    def all_features(self, state: MFGState) -> torch.Tensor:
        """(t, Q, S, hQ, hS, R) stacked: the full-net input."""
        return torch.stack([self._t(state), state.Q, state.S, state.hQ,
                            state.hS, state.R], -1)


def make_mfg_default(nb_days: int = 2, raf_coef: int = 1,
                     jump_factor: float = 2.16, pi: float = 0.1,
                     p0: float = 6.159423723, p1: float = 87.4286117,
                     f0: float = 0.0, f1: float = 1e4,
                     jump_model: str = "stochastic",
                     coeff_equi: float = 1.0) -> SmartGridMFGModel:
    """The mainMFGComparison.py:92-110 default configuration."""
    alpha = 30.0
    return SmartGridMFGModel(
        T=float(nb_days), q_aver=daily_profile(nb_days, raf_coef), R0=2 * 0.12,
        jump_factor=jump_factor, alpha=alpha, beta=float(np.exp(-0.5 * alpha)),
        coeff_ou=5.0, A=150.0, K=50.0, pi=pi, p0=p0, p1=p1, f0=f0, f1=f1,
        theta=0.12, C=80.0, S0=0.0, h1=0.0, h2=600.0, sig0=0.1, sig=0.3,
        alpha_target=-0.2, jump_model=jump_model, coeff_equi=coeff_equi,
    )
