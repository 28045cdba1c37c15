"""Compensated-jump expectation  E_J[ Γ(t, X, J) ].

``kind="quadrature"`` replaces the reference's per-step 5000-sample Monte-Carlo
sweep by a deterministic quadrature over the known jump law: each model's
``jump_quadrature(spec)`` returns (nodes, weights), weights renormalized to
sum to one so a constant Γ is compensated exactly.  The builders are numpy
(host) code, the same rules as the JAX package's ``ops/compensator.py``:
the compound-Poisson mixture of the Merton model and the gamma-subordinated
Laguerre × Hermite rule of the Variance-Gamma model.  ``kind="mc"`` sweeps
fresh draws of the model's own sampler instead (``solvers/pricing.py``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class CompensatorSpec:
    """How to evaluate the inner jump expectation.

    ``n_poisson_max`` Poisson mixture truncation for compound-Poisson laws.
    ``n_hermite``     Gauss-Hermite points for the Gaussian inner integral.
    ``x_interp``      "direct" sweeps every path; "chebyshev" sweeps
                      ``n_cheb`` collocation points (ops/chebyshev.py).
    ``n_laguerre``    generalized Gauss-Laguerre points for a Gamma
                      subordinator (Variance Gamma).
    ``kind="mc"``     sweeps ``n_mc`` draws of the jump law per step.
    The remaining fields mirror the JAX spec so that configurations carry
    across.
    """

    kind: str = "quadrature"
    n_mc: int = 5000
    n_poisson_max: int = 6
    n_hermite: int = 8
    n_laguerre: int = 12
    x_interp: str = "direct"
    n_cheb: int = 32
    cheb_robust_sigmas: float | None = None
    node_block: int | None = None

    def __post_init__(self):
        if self.kind not in ("mc", "quadrature"):
            raise ValueError(f"unknown compensator kind {self.kind!r}")
        if self.x_interp not in ("direct", "chebyshev"):
            raise ValueError(f"unknown x_interp {self.x_interp!r}")


def gauss_hermite(n: int):
    """Probabilists' Gauss-Hermite rule: nodes/weights for E[f(Z)], Z~N(0,1)."""
    x, w = np.polynomial.hermite_e.hermegauss(n)
    w = w / w.sum()
    return x.astype(np.float64), w.astype(np.float64)


def compound_poisson_quadrature(lam_dt: float, mu: float, sig: float,
                                spec: CompensatorSpec):
    """Quadrature for J = dN·mu + sig·sqrt(dN)·Z, dN~Poisson(lam_dt),
    Z~N(0,1): a mixture over k jumps, J | dN=k ~ N(k·mu, k·sig²).  Returns
    flat float32 (nodes, weights), weights renormalized over the truncated
    mixture."""
    z, wz = gauss_hermite(spec.n_hermite)
    nodes = [np.zeros(1)]
    weights = [np.array([np.exp(-lam_dt)])]  # k = 0 -> J = 0 exactly
    pk = np.exp(-lam_dt)
    for k in range(1, spec.n_poisson_max + 1):
        pk = pk * lam_dt / k
        nodes.append(k * mu + sig * np.sqrt(float(k)) * z)
        weights.append(pk * wz)
    nodes = np.concatenate(nodes)
    weights = np.concatenate(weights)
    weights = weights / weights.sum()
    return nodes.astype(np.float32), weights.astype(np.float32)


def gamma_subordinated_quadrature(a: float, scale: float, theta: float,
                                  sig: float, spec: CompensatorSpec):
    """Quadrature for J = theta·G + sig·sqrt(G)·Z, G ~ Gamma(a, scale),
    Z ~ N(0, 1) (the Variance-Gamma increment law): with G = scale·s the
    G-integral is a generalized Gauss-Laguerre rule of alpha = a − 1 (a > 0,
    weights over Γ(a)), crossed with Gauss-Hermite in Z.  Returns flat
    float32 (nodes, weights) of n_laguerre·n_hermite points, weights
    renormalized."""
    from scipy.special import gammaln, roots_genlaguerre

    s, ws = roots_genlaguerre(spec.n_laguerre, a - 1.0)
    ws = ws * np.exp(-gammaln(a))
    z, wz = gauss_hermite(spec.n_hermite)
    g = scale * s                                                  # (L,)
    nodes = theta * g[:, None] + sig * np.sqrt(g)[:, None] * z[None, :]
    weights = (ws[:, None] * wz[None, :]).reshape(-1)
    weights = weights / weights.sum()
    return nodes.reshape(-1).astype(np.float32), weights.astype(np.float32)


def compensated_mean(values: torch.Tensor,
                     weights: torch.Tensor | None) -> torch.Tensor:
    """Weighted mean over the node axis (axis 0) of an [M, ...] sweep;
    ``weights=None`` means uniform."""
    if weights is None:
        return values.mean(dim=0)
    w = weights.reshape((-1,) + (1,) * (values.ndim - 1)).to(values.dtype)
    return (w * values).sum(dim=0)
