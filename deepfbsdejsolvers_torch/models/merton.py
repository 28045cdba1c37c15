"""Merton jump-diffusion pricing model (forward-backward coupled).

* forward asset   X_{i+1} = X_i·exp((r − σ²/2 − λκ̄) dt + σ dW + J)
                            + func(Y − A(i, X_i))·dt
  with κ̄ = e^{μJ+σJ²/2} − 1 and J a compound-Poisson sum over dt;
* closed-form Merton call price A(t, X) as a Poisson-weighted series of
  Black-Scholes prices, its step-dependent parameters tabulated at build;
* driver f(Y) = −rY and payoff g(X) = (X − K)⁺.

The model holds host (numpy float32) tables and follows the device of the
tensors it is given; each table is copied to a device once.  With
``price_mode="table"`` the price is read from per-step curves on
``table_points`` log-moneyness points in [−``table_log_m_max``,
``table_log_m_max``], built on the host in float64 as the JAX package builds
them, by the Catmull-Rom cubic of ``ops/interp.py``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import numpy as np
import torch

from deepfbsdejsolvers_torch.ops.compensator import (
    CompensatorSpec,
    compound_poisson_quadrature,
)
from deepfbsdejsolvers_torch.ops.noise import icdf_jumps
from deepfbsdejsolvers_torch.ops.numerics import mul_exp
from deepfbsdejsolvers_torch.utils import profiling


def abs_coupling(a_lin: float) -> Callable[[torch.Tensor], torch.Tensor]:
    """The forward-backward coupling func(u) = aLin·|u|."""

    def func(u):
        return a_lin * torch.abs(u)

    return func


@dataclasses.dataclass(frozen=True)
class MertonJumpModel:
    """Pure-functional Merton model; ``coupling`` is the functor injected
    into the forward drift."""

    regime = "jump_diffusion"  # has a Brownian Z·dW term in the BSDE

    T: float
    N: int
    r: float
    muJ: float
    sigJ: float
    sigma: float
    lam: float
    K: float
    x0: float
    coupling: Callable[[torch.Tensor], torch.Tensor]
    limit: int = 30
    # "series" evaluates the power series exactly per call; "table" reads
    # per-step price curves over log-moneyness by a cubic; "chebyshev"
    # evaluates it at n_cheb_price Chebyshev points spanning a 1-D batch of
    # at least 4·n_cheb_price spots and reconstructs per path by Clenshaw.
    price_mode: str = "series"
    n_cheb_price: int = 64
    # "exact" draws Poisson counts with torch.poisson; "icdf" inverts the
    # CDF truncated at 1e-9 tail mass.
    jump_sampler: str = "exact"
    table_points: int = 4097
    table_log_m_max: float = 5.0

    def __post_init__(self):
        if self.price_mode not in ("series", "table", "chebyshev"):
            raise ValueError(f"price_mode must be series|table|chebyshev, got "
                             f"{self.price_mode!r}")
        if self.jump_sampler not in ("exact", "icdf"):
            raise ValueError(
                f"jump_sampler must be exact|icdf, got {self.jump_sampler!r}")
        dt = self.T / self.N
        kbar = math.exp(self.muJ + 0.5 * self.sigJ**2) - 1.0
        lam2 = self.lam * (kbar + 1.0)

        i = np.arange(self.N, dtype=np.float64)[:, None]
        k = np.arange(self.limit, dtype=np.float64)[None, :]
        tau = self.T - i * dt
        r_bs = self.r - self.lam * kbar + k * (self.muJ + 0.5 * self.sigJ**2) / tau
        sig_bs = np.sqrt(self.sigma**2 + k * self.sigJ**2 / tau)
        from scipy.special import gammaln

        log_coeff = -lam2 * tau + k * np.log(lam2 * tau) - gammaln(k + 1.0)
        tables = {
            "tau": tau[:, 0].astype(np.float32),
            "r_bs": r_bs.astype(np.float32),
            "sig_bs": sig_bs.astype(np.float32),
            "coeff": np.exp(log_coeff).astype(np.float32),
        }
        if self.price_mode == "table":
            g, curves = self._price_curves(tau, r_bs, sig_bs,
                                           np.exp(log_coeff))
            tables["price_table"] = curves.astype(np.float32)
            object.__setattr__(self, "_g0", float(g[0]))
            object.__setattr__(self, "_dg", float(g[1] - g[0]))
        if self.jump_sampler == "icdf":
            from scipy.stats import poisson as sp_poisson

            lam_dt = self.lam * dt
            k_max = int(sp_poisson.ppf(1.0 - 1e-9, lam_dt)) + 1
            tables["poisson_cdf"] = sp_poisson.cdf(
                np.arange(k_max), lam_dt).astype(np.float32)
        object.__setattr__(self, "_dt", float(dt))
        object.__setattr__(self, "_kbar", float(kbar))
        object.__setattr__(self, "_host", tables)
        object.__setattr__(self, "_dev", {})

    def _price_curves(self, tau, r_bs, sig_bs, coeff):
        """(grid g (G,), curves (N, G)): the series price at spots K·e^g of
        each step, in float64 on the host."""
        from scipy.special import ndtr

        g = np.linspace(-self.table_log_m_max, self.table_log_m_max,
                        self.table_points)
        x = self.K * np.exp(g)
        sqrt_tau = np.sqrt(tau)                                  # (N, 1)
        d1 = (g[None, :, None] + (r_bs + 0.5 * sig_bs**2)[:, None, :]
              * tau[:, None, :]) / (sig_bs[:, None, :] * sqrt_tau[:, None, :])
        d2 = d1 - (sig_bs * sqrt_tau)[:, None, :]
        bs = (x[None, :, None] * ndtr(d1)
              - self.K * np.exp(-r_bs * tau)[:, None, :] * ndtr(d2))
        return g, np.einsum("ngl,nl->ng", bs, coeff)

    def tables(self, device) -> dict:
        """The host tables as tensors on ``device`` (copied on first use)."""
        device = torch.device(device)
        if device not in self._dev:
            self._dev[device] = {k: torch.as_tensor(v, device=device)
                                 for k, v in self._host.items()}
        return self._dev[device]

    # ---- scalars -----------------------------------------------------------
    @property
    def dt(self) -> float:
        return self._dt

    # ---- forward dynamics ---------------------------------------------------
    def init_x(self, batch: int, device="cuda") -> torch.Tensor:
        """X_0 for every path."""
        return torch.full((batch,), self.x0, dtype=torch.float32,
                          device=device)

    def sample_jumps(self, generator: torch.Generator, shape) -> torch.Tensor:
        """Compound-Poisson jump sum over one dt on ``generator``'s device:
        J = dN·μJ + σJ·sqrt(dN)·N(0,1), dN ~ Poisson(λ dt).  The icdf
        sampler draws u then z and forms J in ``ops/noise.icdf_jumps``
        (one kernel on a card)."""
        device = generator.device
        if self.jump_sampler == "icdf":
            u = torch.rand(shape, generator=generator, device=device)
            z = torch.randn(shape, generator=generator, device=device)
            return icdf_jumps(u, z, self.tables("cpu")["poisson_cdf"],
                              self.muJ, self.sigJ)
        rate = torch.full(shape, self.lam * self._dt, device=device)
        dn = torch.poisson(rate, generator=generator)
        z = torch.randn(shape, generator=generator, device=device)
        return dn * self.muJ + self.sigJ * torch.sqrt(dn) * z

    def step(self, i, x: torch.Tensor, dw: torch.Tensor, jump: torch.Tensor,
             y: torch.Tensor, price: Optional[torch.Tensor] = None
             ) -> torch.Tensor:
        """One Euler step of the coupled forward SDE; ``price`` optionally
        supplies a precomputed A(i, X) (the hoisted tables)."""
        drift = (self.r - 0.5 * self.sigma**2 - self.lam * self._kbar) * self._dt
        a = self.price(i, x) if price is None else price
        return mul_exp(x, drift + self.sigma * dw + jump) + self.coupling(
            y - a) * self._dt

    def uncoupled_log_increments(self, dw: torch.Tensor,
                                 jump: torch.Tensor) -> torch.Tensor:
        """log x_{i+1} − log x_i of the uncoupled dynamics: drift + σ dW + J."""
        drift = (self.r - 0.5 * self.sigma**2 - self.lam * self._kbar) * self._dt
        return drift + self.sigma * dw + jump

    # ---- closed-form pricer --------------------------------------------------
    @profiling.spanned("fbsde.price")
    def price(self, i, x: torch.Tensor) -> torch.Tensor:
        """Merton call price A(i·dt, x).  ``i`` is an int or an integer
        tensor that broadcasts against ``x``."""
        if self.price_mode == "table":
            from deepfbsdejsolvers_torch.ops.interp import uniform_interp_cubic

            return uniform_interp_cubic(
                self.tables(x.device)["price_table"], torch.log(x / self.K),
                self._g0, self._dg, row=i)
        if (self.price_mode == "chebyshev" and x.ndim == 1
                and x.shape[0] >= 4 * self.n_cheb_price):
            from deepfbsdejsolvers_torch.ops.chebyshev import interp_1d

            return interp_1d(lambda xn: self._price_series(i, xn), x,
                             self.n_cheb_price)
        return self._price_series(i, x)

    def _price_series(self, i, x: torch.Tensor) -> torch.Tensor:
        """The exact ``limit``-term power series."""
        tb = self.tables(x.device)
        tau = tb["tau"][i][..., None]
        r_bs = tb["r_bs"][i]
        sig_bs = tb["sig_bs"][i]
        coeff = tb["coeff"][i]
        log_m = torch.log(x / self.K)[..., None]
        sqrt_tau = torch.sqrt(tau)
        d1 = (log_m + (r_bs + 0.5 * sig_bs**2) * tau) / (sig_bs * sqrt_tau)
        d2 = (log_m + (r_bs - 0.5 * sig_bs**2) * tau) / (sig_bs * sqrt_tau)
        nd = torch.special.ndtr
        bs = x[..., None] * nd(d1) - self.K * torch.exp(-r_bs * tau) * nd(d2)
        return (coeff * bs).sum(-1)

    def price_at_origin(self) -> float:
        """Reference price A(0, x0), the accuracy oracle."""
        return float(self.price(0, torch.tensor([self.x0]))[0])

    # ---- BSDE pieces ----------------------------------------------------------
    def f(self, y: torch.Tensor) -> torch.Tensor:
        """Driver f(Y) = −rY."""
        return -self.r * y

    def payoff(self, x: torch.Tensor) -> torch.Tensor:
        """g(X) = max(X − K, 0)."""
        return torch.clamp(x - self.K, min=0.0)

    # ---- compensator quadrature -------------------------------------------------
    def jump_quadrature(self, spec: CompensatorSpec):
        """Deterministic (nodes, weights) over the Merton jump law, as CPU
        float32 tensors."""
        nodes, weights = compound_poisson_quadrature(
            self.lam * self._dt, self.muJ, self.sigJ, spec)
        return torch.as_tensor(nodes), torch.as_tensor(weights)


def make_merton_default(a_lin: float = 0.1, limit: int = 30,
                        price_mode: str = "series",
                        jump_sampler: str = "exact") -> MertonJumpModel:
    """The reference's default Merton configuration (mainMerton.py)."""
    return MertonJumpModel(
        T=1.0, N=50, r=0.1, muJ=0.0, sigJ=0.2, sigma=0.3, lam=3.0, K=0.9,
        x0=1.0, coupling=abs_coupling(a_lin), limit=limit,
        price_mode=price_mode, jump_sampler=jump_sampler,
    )
