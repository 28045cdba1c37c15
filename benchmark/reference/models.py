"""The two pricing models of the configurations, written plainly from their
published equations (the reference's ``mainMerton.py`` and ``mainVG.py``):
settings, the noise drawn from a generator in the order the training
step draws it, the forward step, the call price, and the jump law's
quadrature.  Host tables are built in float64 and used in float32.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_TAYLOR_CUT = 0.125


def expm1_acc(u: torch.Tensor) -> torch.Tensor:
    """e^u − 1: a degree-7 Horner Taylor polynomial on |u| < 1/8, exp(u) − 1
    beyond."""
    p = u / 7.0
    for k in (6.0, 5.0, 4.0, 3.0, 2.0):
        p = (1.0 + p) * u / k
    return torch.where(u.abs() < _TAYLOR_CUT, u * (1.0 + p),
                       torch.exp(u) - 1.0)


def mul_exp(x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """x·e^u with the identity part of the factor carried exactly."""
    return x + x * expm1_acc(u)


def hermite(n: int):
    """Probabilists' Gauss-Hermite nodes and weights summing to one."""
    x, w = np.polynomial.hermite_e.hermegauss(n)
    return x, w / w.sum()


def catmull_rom(table: torch.Tensor, row, x: torch.Tensor, x0: float,
                dx: float) -> torch.Tensor:
    """Catmull-Rom cubic of the curve ``table[row]`` sampled at x0 + k·dx,
    at x, the cell clamped to the table and the stencil's ends too."""
    n = table.shape[-1]
    pos = (x - x0) / dx
    idx = torch.clamp(torch.floor(pos), 0, n - 2).long()
    t = pos - idx.to(pos.dtype)
    row = torch.as_tensor(row, device=table.device).long()
    read = lambda k: table[row, torch.clamp(k, 0, n - 1)]
    p0, p1, p2, p3 = read(idx - 1), read(idx), read(idx + 1), read(idx + 2)
    t2 = t * t
    return 0.5 * (2.0 * p1 + (p2 - p0) * t
                  + (2.0 * p0 - 5.0 * p1 + 4.0 * p2 - p3) * t2
                  + (3.0 * p1 - p0 - 3.0 * p2 + p3) * t2 * t)


class Merton:
    """Merton jump-diffusion: X_{i+1} = X_i·exp(drift + σdW + J) +
    aLin·|Y − A(i, X_i)|·dt, J compound Poisson N(μJ, σJ²) jumps at rate λ,
    A the Merton call price as a Poisson series of Black-Scholes prices."""

    jump_diffusion = True

    def __init__(self, cfg: dict, device, jump_sampler: str = "exact"):
        self.T, self.N = float(cfg["T"]), int(cfg["N"])
        self.r, self.sigma = float(cfg["r"]), float(cfg["sigma"])
        self.lam, self.muJ = float(cfg["lam"]), float(cfg["muJ"])
        self.sigJ, self.K = float(cfg["sigJ"]), float(cfg["K"])
        self.x0, self.a_lin = float(cfg["x0"]), float(cfg["aLin"])
        self.limit = int(cfg["series_terms"])
        self.jump_sampler = jump_sampler
        self.dt = self.T / self.N
        kbar = math.exp(self.muJ + 0.5 * self.sigJ ** 2) - 1.0
        self.drift = (self.r - 0.5 * self.sigma ** 2 - self.lam * kbar) \
            * self.dt
        i = np.arange(self.N, dtype=np.float64)[:, None]
        k = np.arange(self.limit, dtype=np.float64)[None, :]
        tau = self.T - i * self.dt
        lam2 = self.lam * (kbar + 1.0)
        r_bs = (self.r - self.lam * kbar
                + k * (self.muJ + 0.5 * self.sigJ ** 2) / tau)
        sig_bs = np.sqrt(self.sigma ** 2 + k * self.sigJ ** 2 / tau)
        from scipy.special import gammaln

        coeff = np.exp(-lam2 * tau + k * np.log(lam2 * tau)
                       - gammaln(k + 1.0))
        as32 = lambda a: torch.as_tensor(np.asarray(a, np.float32),
                                         device=device)
        self.tau, self.r_bs = as32(tau[:, 0]), as32(r_bs)
        self.sig_bs, self.coeff = as32(sig_bs), as32(coeff)
        if jump_sampler == "icdf":
            from scipy.stats import poisson

            lam_dt = self.lam * self.dt
            k_max = int(poisson.ppf(1.0 - 1e-9, lam_dt)) + 1
            self.cdf = as32(poisson.cdf(np.arange(k_max), lam_dt))

    def jumps(self, g: torch.Generator, shape) -> torch.Tensor:
        """J = dN·μJ + σJ·√dN·Z: dN by the inverse CDF of a uniform
        (``icdf``) or by ``torch.poisson`` (``exact``), then Z."""
        dev = g.device
        if self.jump_sampler == "icdf":
            u = torch.rand(shape, generator=g, device=dev)
            dn = (u[..., None] > self.cdf).sum(-1).to(torch.float32)
        else:
            dn = torch.poisson(torch.full(shape, self.lam * self.dt,
                                          device=dev), generator=g)
        z = torch.randn(shape, generator=g, device=dev)
        return dn * self.muJ + self.sigJ * torch.sqrt(dn) * z

    def draw(self, g: torch.Generator, batch: int):
        """(dW, J), both (N, batch): dW first, then the jumps."""
        dw = math.sqrt(self.dt) * torch.randn((self.N, batch), generator=g,
                                              device=g.device)
        return dw, self.jumps(g, (self.N, batch))

    def log_increments(self, dw, j):
        return self.drift + self.sigma * dw + j

    def step(self, x, dw, j, y, a):
        return mul_exp(x, self.drift + self.sigma * dw + j) \
            + self.a_lin * torch.abs(y - a) * self.dt

    def price(self, i, x: torch.Tensor) -> torch.Tensor:
        """A(i·dt, x) by the ``series_terms``-term series; ``i`` an int or
        an integer tensor broadcasting against x."""
        tau = self.tau[i][..., None]
        r_bs, sig_bs, coeff = self.r_bs[i], self.sig_bs[i], self.coeff[i]
        log_m = torch.log(x / self.K)[..., None]
        sq = torch.sqrt(tau)
        d1 = (log_m + (r_bs + 0.5 * sig_bs ** 2) * tau) / (sig_bs * sq)
        d2 = (log_m + (r_bs - 0.5 * sig_bs ** 2) * tau) / (sig_bs * sq)
        nd = torch.special.ndtr
        bs = x[..., None] * nd(d1) - self.K * torch.exp(-r_bs * tau) * nd(d2)
        return (coeff * bs).sum(-1)

    def quadrature(self, n_poisson: int, n_hermite: int, device):
        """(nodes, weights) of J: k = 0 … n_poisson jumps, each a Hermite
        rule of N(k·μJ, k·σJ²), weights renormalized."""
        z, wz = hermite(n_hermite)
        lam_dt = self.lam * self.dt
        nodes, weights, pk = [np.zeros(1)], [np.array([np.exp(-lam_dt)])], \
            np.exp(-lam_dt)
        for k in range(1, n_poisson + 1):
            pk = pk * lam_dt / k
            nodes.append(k * self.muJ + self.sigJ * np.sqrt(float(k)) * z)
            weights.append(pk * wz)
        nodes, weights = np.concatenate(nodes), np.concatenate(weights)
        weights = weights / weights.sum()
        return (torch.as_tensor(nodes.astype(np.float32), device=device),
                torch.as_tensor(weights.astype(np.float32), device=device))


class VarianceGamma:
    """Variance-Gamma pure jumps: X_{i+1} = X_i·exp((r − ω)dt + J) +
    aLin·|Y − A(i, X_i)|·dt, J = θG + σJ√G·Z with G ~ Gamma(dt/κ, κ); A
    the Carr-Madan FFT call price on a 2^15-point log-moneyness grid."""

    jump_diffusion = False
    FFT_N, FFT_B = 2 ** 15, 500.0

    def __init__(self, cfg: dict, device, jump_sampler: str = "exact"):
        if jump_sampler != "exact":
            raise ValueError("the reference draws VG jumps exactly")
        self.T, self.N = float(cfg["T"]), int(cfg["N"])
        self.r, self.theta = float(cfg["r"]), float(cfg["theta"])
        self.kappa, self.sigJ = float(cfg["kappa"]), float(cfg["sigJ"])
        self.K, self.x0 = float(cfg["K"]), float(cfg["x0"])
        self.a_lin = float(cfg["aLin"])
        self.dt = self.T / self.N
        self.omega = -math.log(1.0 - self.theta * self.kappa
                               - 0.5 * self.kappa * self.sigJ ** 2) \
            / self.kappa
        n, b_max = self.FFT_N, self.FFT_B
        du = b_max / n
        k = np.arange(n)
        u = k * du
        lm = 2.0 * np.pi / b_max
        b = n * lm / 2.0
        simpson = 3.0 + (-1.0) ** (k + 1)
        simpson[0] = simpson[-1] = 1.0
        rows = []
        for i in range(self.N):
            tau = self.T - i * self.dt
            v = u - 0.5j
            phi = np.exp(tau * (1j * (self.r - self.omega) * v - np.log(
                1.0 - 1j * self.theta * self.kappa * v
                + 0.5 * self.kappa * self.sigJ ** 2 * v * v) / self.kappa))
            rows.append(np.real(np.fft.ifft(
                np.exp(-1j * b * u) * phi / (u ** 2 + 0.25) * simpson * du
                / 3.0) * n))
        self.curve = torch.as_tensor(np.stack(rows).astype(np.float32),
                                     device=device)
        self.grid = (float(-b), float(lm))

    def jumps(self, g: torch.Generator, shape) -> torch.Tensor:
        dev = g.device
        gam = torch._standard_gamma(
            torch.full(shape, self.dt / self.kappa, device=dev),
            generator=g) * self.kappa
        z = torch.randn(shape, generator=g, device=dev)
        return self.theta * gam + self.sigJ * torch.sqrt(gam) * z

    def draw(self, g: torch.Generator, batch: int):
        """(dW, J): no Brownian term, so dW is (N, 0) and draws nothing."""
        dw = torch.zeros((self.N, 0), device=g.device)
        return dw, self.jumps(g, (self.N, batch))

    def log_increments(self, dw, j):
        return (self.r - self.omega) * self.dt + j

    def step(self, x, dw, j, y, a):
        return mul_exp(x, (self.r - self.omega) * self.dt + j) \
            + self.a_lin * torch.abs(y - a) * self.dt

    def price(self, i, x: torch.Tensor) -> torch.Tensor:
        """Carr-Madan: x − √(xK)·e^{−rτ}/π·curve_i(log(x/K))."""
        spline = catmull_rom(self.curve, i, torch.log(x / self.K),
                             *self.grid)
        step = torch.as_tensor(i, device=x.device).to(torch.float32)
        tau = self.T - step * self.dt
        return x - torch.sqrt(x * self.K) * torch.exp(-self.r * tau) \
            / math.pi * spline

    def quadrature(self, n_laguerre: int, n_hermite: int, device):
        """(nodes, weights) of J = θG + σJ√G·Z: generalized Gauss-Laguerre
        in G (α = dt/κ − 1) crossed with Hermite in Z, renormalized."""
        from scipy.special import gammaln, roots_genlaguerre

        a = self.dt / self.kappa
        s, ws = roots_genlaguerre(n_laguerre, a - 1.0)
        ws = ws * np.exp(-gammaln(a))
        z, wz = hermite(n_hermite)
        gg = self.kappa * s
        nodes = self.theta * gg[:, None] + self.sigJ * np.sqrt(gg)[:, None] \
            * z[None, :]
        weights = (ws[:, None] * wz[None, :]).reshape(-1)
        weights = weights / weights.sum()
        return (torch.as_tensor(nodes.reshape(-1).astype(np.float32),
                                device=device),
                torch.as_tensor(weights.astype(np.float32), device=device))


MODELS = {"merton": Merton, "variance_gamma": VarianceGamma}
