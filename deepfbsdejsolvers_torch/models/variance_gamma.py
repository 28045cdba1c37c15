"""Variance-Gamma pure-jump pricing model (forward-backward coupled).

* forward asset   X_{i+1} = X_i·exp((r − ω) dt + J) + func(Y − A(i, X_i))·dt,
  with no Brownian term: J = θG + σJ√G·Z is a gamma-subordinated Brownian
  increment, G ~ Gamma(dt/κ, scale κ), and ω = −log(1 − θκ − κσJ²/2)/κ
  the martingale correction, so that E[e^J] = e^{ω dt};
* European call price A(t, X) from the VG characteristic function, by one
  of two pricers:
  - ``pricer="fft"``: the Carr-Madan 2^15-point FFT curve on a uniform
    log-moneyness grid, one row per step;
  - ``pricer="invfourier"``: the Gil-Pelaez exercise probabilities Q1, Q2
    by the trapezoid rule on a 1000-point grid, tabulated per step on a
    uniform grid of log(K/X);
  both tables depend on the step alone, so they are built once on the host
  (numpy float64/complex128) when the model is made, and a query is a
  Catmull-Rom interpolation on the device (``ops/interp.py``);
* driver f(Y) = −rY and payoff g(X) = (X − K)⁺.

The model holds host (numpy float32) tables and follows the device of the
tensors it is given; each table is copied to a device once.  The builders
are this package's own copies of the JAX package's
``models/variance_gamma.py``, and tests hold their tables equal.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import numpy as np
import torch

from deepfbsdejsolvers_torch.models.merton import abs_coupling
from deepfbsdejsolvers_torch.ops.compensator import (
    CompensatorSpec,
    gamma_subordinated_quadrature,
)
from deepfbsdejsolvers_torch.ops.interp import uniform_interp_cubic
from deepfbsdejsolvers_torch.ops.numerics import mul_exp
from deepfbsdejsolvers_torch.utils import profiling

_FFT_N = 2**15
_FFT_B = 500.0


@dataclasses.dataclass(frozen=True)
class VGModel:
    """Pure-functional Variance-Gamma model; ``coupling`` is the functor
    injected into the forward drift."""

    regime = "pure_jump"  # no Brownian term: the BSDE is driven by jumps

    T: float
    N: int
    r: float
    theta: float
    kappa: float
    sigJ: float
    K: float
    x0: float
    coupling: Callable[[torch.Tensor], torch.Tensor]
    pricer: str = "fft"
    # "direct" interpolates the price table at every path; "chebyshev"
    # interpolates it at n_cheb_price Chebyshev points spanning a 1-D batch
    # of at least 4·n_cheb_price spots and reconstructs per path
    price_eval: str = "direct"
    n_cheb_price: int = 64
    cheb_robust_sigmas: float | None = None
    # "exact" draws G by torch's gamma sampler; "icdf" maps a normal draw z
    # through the subordinator's quantile, G = κ·F⁻¹(Φ(z)), tabulated as
    # icdf_pieces piecewise Chebyshev series of degree icdf_degree on
    # |z| ≤ icdf_zmax (the shape dt/κ is fixed, so the table is too)
    jump_sampler: str = "exact"
    icdf_pieces: int = 16
    icdf_degree: int = 7
    icdf_zmax: float = 5.5

    def __post_init__(self):
        if self.jump_sampler not in ("exact", "icdf"):
            raise ValueError(f"jump_sampler must be 'exact' or 'icdf', got "
                             f"{self.jump_sampler!r}")
        if self.pricer not in ("fft", "invfourier"):
            raise ValueError(f"pricer must be 'fft' or 'invfourier', got "
                             f"{self.pricer!r}")
        if self.price_eval not in ("direct", "chebyshev"):
            raise ValueError(f"price_eval must be 'direct' or 'chebyshev', "
                             f"got {self.price_eval!r}")
        dt = self.T / self.N
        correction = -math.log(1.0 - self.theta * self.kappa
                               - 0.5 * self.kappa * self.sigJ**2) / self.kappa
        object.__setattr__(self, "_dt", float(dt))
        object.__setattr__(self, "_correction", float(correction))
        tables = {}
        if self.pricer == "fft":
            tables["fft"], ku0, dku = self._build_fft_tables()
            object.__setattr__(self, "_grid", (float(ku0), float(dku)))
        else:
            tables["q1"], tables["q2"], k0, dk = \
                self._build_invfourier_tables()
            object.__setattr__(self, "_grid", (float(k0), float(dk)))
        if self.jump_sampler == "icdf":
            tables["g_coef"] = self._build_gamma_icdf_table().astype(
                np.float32)
        object.__setattr__(self, "_host", tables)
        object.__setattr__(self, "_dev", {})

    def tables(self, device) -> dict:
        """The host tables as tensors on ``device`` (copied on first use)."""
        device = torch.device(device)
        if device not in self._dev:
            self._dev[device] = {k: torch.as_tensor(v, device=device)
                                 for k, v in self._host.items()}
        return self._dev[device]

    # ---- host table builders ------------------------------------------------
    def _build_gamma_icdf_table(self) -> np.ndarray:
        """(P, D+1) piecewise Chebyshev coefficients of z ↦ κ·F⁻¹(Φ(z)),
        F the Gamma(dt/κ) law, on [−icdf_zmax, icdf_zmax], fitted in
        float64 (in f32, Φ(z) rounds to 1 inside the range)."""
        from scipy.special import ndtr
        from scipy.stats import gamma as sp_gamma

        from deepfbsdejsolvers_torch.ops.piecewise import (
            _pw_cheb_fit, _pw_tables)

        p, deg = self.icdf_pieces, self.icdf_degree
        t_glob = np.asarray(_pw_tables(p, deg), np.float64)
        z = -self.icdf_zmax + 2.0 * self.icdf_zmax * t_glob
        g = sp_gamma.ppf(ndtr(z), self._dt / self.kappa) * self.kappa
        fit = np.asarray(_pw_cheb_fit(deg), np.float64)
        return g.reshape(p, deg + 1) @ fit.T

    def _phi_np(self, i_step: int, u: np.ndarray) -> np.ndarray:
        """The characteristic function φ(t_i, u) at complex u, complex128."""
        tau = self.T - i_step * self._dt
        inner = (1.0 - 1j * self.theta * self.kappa * u
                 + 0.5 * self.kappa * self.sigJ**2 * u * u)
        return np.exp(tau * (1j * (self.r - self._correction) * u
                             - np.log(inner) / self.kappa))

    def _build_fft_tables(self):
        """(N, 2^15) Carr-Madan curves on the grid ku = −b + lm·k, and
        (−b, lm)."""
        n, b_max = _FFT_N, _FFT_B
        du = b_max / n
        k = np.arange(n)
        u = k * du
        lm = 2.0 * np.pi / b_max
        b = n * lm / 2.0
        weight = 3.0 + (-1.0) ** (k + 1)
        weight[0] = 1.0
        weight[-1] = 1.0
        rows = []
        for i_step in range(self.N):
            integrand = (np.exp(-1j * b * u) * self._phi_np(i_step, u - 0.5j)
                         / (u**2 + 0.25) * weight * du / 3.0)
            rows.append(np.real(np.fft.ifft(integrand) * n))
        return np.stack(rows).astype(np.float32), -b, lm

    def _build_invfourier_tables(self, n_k: int = 4097, k_max: float = 4.0,
                                 n_grid: int = 1000, u_max: float = 5000.0):
        """(N, n_k) Gil-Pelaez Q1 and Q2 on the uniform grid k = log(K/X),
        and the grid's (k_0, dk); the pole at u = −i is avoided at
        −1.0000000000001i, as in the reference."""
        trapezoid = getattr(np, "trapezoid", None) or np.trapz
        k = np.linspace(-k_max, k_max, n_k)
        u = np.linspace(1e-15, u_max, n_grid)[:, None]
        q1_rows, q2_rows = [], []
        for i_step in range(self.N):
            denom = self._phi_np(i_step, np.array(-1.0000000000001j))
            phase = np.exp(-1j * u * k[None, :]) / (1j * u)
            int1 = np.real(phase * (self._phi_np(i_step, u - 1j) / denom))
            int2 = np.real(phase * self._phi_np(i_step, u))
            q1_rows.append(0.5 + trapezoid(int1, u[:, 0], axis=0) / np.pi)
            q2_rows.append(0.5 + trapezoid(int2, u[:, 0], axis=0) / np.pi)
        return (np.stack(q1_rows).astype(np.float32),
                np.stack(q2_rows).astype(np.float32),
                float(k[0]), float(k[1] - k[0]))

    # ---- scalars ----------------------------------------------------------
    @property
    def dt(self) -> float:
        return self._dt

    @property
    def correction(self) -> float:
        """The martingale correction ω."""
        return self._correction

    # ---- forward dynamics ---------------------------------------------------
    def init_x(self, batch: int, device="cuda") -> torch.Tensor:
        """X_0 for every path."""
        return torch.full((batch,), self.x0, dtype=torch.float32,
                          device=device)

    def sample_gamma(self, generator: torch.Generator, shape) -> torch.Tensor:
        """The subordinator's increment G ~ Gamma(dt/κ, scale κ) on
        ``generator``'s device, by the configured sampler."""
        device = generator.device
        if self.jump_sampler == "icdf":
            from deepfbsdejsolvers_torch.ops.piecewise import pw_eval

            zg = torch.randn(shape, generator=generator, device=device)
            zmax = torch.tensor(self.icdf_zmax, device=device)
            flat = pw_eval(self.tables(device)["g_coef"], zg.reshape(-1),
                           -zmax, zmax)
            # the fit dips ~1e-9 below 0 on the flat left end; √G needs ≥ 0
            return torch.clamp(flat.reshape(shape), min=0.0)
        alpha = torch.full(shape, self._dt / self.kappa, device=device)
        return torch._standard_gamma(alpha, generator=generator) * self.kappa

    def sample_jumps(self, generator: torch.Generator, shape) -> torch.Tensor:
        """The VG increment over one dt: J = θG + σJ√G·Z."""
        g = self.sample_gamma(generator, shape)
        z = torch.randn(shape, generator=generator, device=generator.device)
        return self.theta * g + self.sigJ * torch.sqrt(g) * z

    def step(self, i, x: torch.Tensor, jump: torch.Tensor, y: torch.Tensor,
             price: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One step of the coupled pure-jump forward SDE (no dW); ``price``
        optionally supplies a precomputed A(i, X) (the hoisted tables)."""
        a = self.price(i, x) if price is None else price
        return mul_exp(x, (self.r - self._correction) * self._dt + jump) \
            + self.coupling(y - a) * self._dt

    def uncoupled_log_increments(self, dw: torch.Tensor,
                                 jump: torch.Tensor) -> torch.Tensor:
        """log x_{i+1} − log x_i of the uncoupled dynamics, (r − ω) dt + J;
        ``dw`` is the pure-jump regime's zero-width placeholder, unread."""
        del dw
        return (self.r - self._correction) * self._dt + jump

    # ---- pricers ------------------------------------------------------------
    @profiling.spanned("fbsde.price")
    def price(self, i, x: torch.Tensor) -> torch.Tensor:
        """The call price A(i·dt, x); ``i`` is an int or an integer tensor
        that broadcasts against ``x``."""
        if (self.price_eval == "chebyshev" and x.ndim == 1
                and x.shape[0] >= 4 * self.n_cheb_price):
            from deepfbsdejsolvers_torch.ops.chebyshev import interp_1d

            return interp_1d(lambda xn: self._price_direct(i, xn), x,
                             self.n_cheb_price,
                             robust_sigmas=self.cheb_robust_sigmas)
        return self._price_direct(i, x)

    def _price_direct(self, i, x: torch.Tensor) -> torch.Tensor:
        if self.pricer == "fft":
            return self.price_fft(i, x)
        return self.price_invfourier(i, x)

    def _tau(self, i, x: torch.Tensor) -> torch.Tensor:
        """T − i·dt in float32 on x's device."""
        step = torch.as_tensor(i, device=x.device).to(torch.float32)
        return self.T - step * self._dt

    def price_fft(self, i, x: torch.Tensor) -> torch.Tensor:
        """Carr-Madan price: the step's curve interpolated at log(X/K)."""
        ku0, dku = self._grid
        spline = uniform_interp_cubic(self.tables(x.device)["fft"],
                                      torch.log(x / self.K), ku0, dku, row=i)
        tau = self._tau(i, x)
        return x - torch.sqrt(x * self.K) * torch.exp(-self.r * tau) \
            / math.pi * spline

    def price_invfourier(self, i, x: torch.Tensor) -> torch.Tensor:
        """Gil-Pelaez price X·Q1 − K e^{−rτ}·Q2, the probabilities
        interpolated at k = log(K/X)."""
        k0, dk = self._grid
        tb = self.tables(x.device)
        k = torch.log(self.K / x)
        q1 = uniform_interp_cubic(tb["q1"], k, k0, dk, row=i)
        q2 = uniform_interp_cubic(tb["q2"], k, k0, dk, row=i)
        return x * q1 - self.K * torch.exp(-self.r * self._tau(i, x)) * q2

    def price_at_origin(self) -> float:
        """Reference price A(0, x0), the accuracy oracle."""
        return float(self.price(0, torch.tensor([self.x0]))[0])

    # ---- BSDE pieces --------------------------------------------------------
    def f(self, y: torch.Tensor) -> torch.Tensor:
        """Driver f(Y) = −rY."""
        return -self.r * y

    def payoff(self, x: torch.Tensor) -> torch.Tensor:
        """g(X) = max(X − K, 0)."""
        return torch.clamp(x - self.K, min=0.0)

    # ---- compensator quadrature ---------------------------------------------
    def jump_quadrature(self, spec: CompensatorSpec):
        """Deterministic (nodes, weights) over the VG increment law, as CPU
        float32 tensors."""
        nodes, weights = gamma_subordinated_quadrature(
            self._dt / self.kappa, self.kappa, self.theta, self.sigJ, spec)
        return torch.as_tensor(nodes), torch.as_tensor(weights)


def make_vg_default(a_lin: float = 0.1, pricer: str = "fft",
                    jump_sampler: str = "exact") -> VGModel:
    """The reference's default Variance-Gamma configuration (mainVG.py)."""
    return VGModel(T=1.0, N=30, r=0.1, theta=-0.1, kappa=0.1, sigJ=0.2,
                   K=1.0, x0=1.0, coupling=abs_coupling(a_lin),
                   pricer=pricer, jump_sampler=jump_sampler)
