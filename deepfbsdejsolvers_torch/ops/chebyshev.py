"""Chebyshev collocation of a 1-D smooth function of the spot.

``comp(x) = E_J[Γ(t, x, J)]`` and the Merton price A(i, x) are smooth
functions of x alone, so they are evaluated exactly at n Chebyshev points
spanning the batch's spot range, fitted by a DCT matrix, and reconstructed per
path as the sum of the series (``ChebSeries``).  The interval endpoints are
detached: the interval is a numerical device, not part of the function
differentiated.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def _cheb_tables(n: int):
    """Chebyshev-Gauss points u_k on [-1, 1] and the DCT-II fit matrix F with
    coef = F @ f(u_nodes) giving f(u) ≈ sum_j coef_j T_j(u) (host numpy)."""
    k = np.arange(n)
    u = np.cos(np.pi * (k + 0.5) / n)
    T = np.cos(np.pi * np.outer(np.arange(n), (k + 0.5)) / n)
    F = (2.0 / n) * T
    F[0] *= 0.5
    return u.astype(np.float32), F.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _cheb_tables_on(n: int, device: torch.device):
    """``_cheb_tables`` as tensors on ``device``, copied once per device."""
    u, f = _cheb_tables(n)
    return torch.as_tensor(u, device=device), torch.as_tensor(f, device=device)


def cheb_nodes(x_lo: torch.Tensor, x_hi: torch.Tensor, n: int) -> torch.Tensor:
    """Chebyshev-Gauss points mapped to [x_lo, x_hi] (ends detached)."""
    u = _cheb_tables_on(n, x_lo.device)[0]
    x_lo, x_hi = x_lo.detach(), x_hi.detach()
    return 0.5 * (x_lo + x_hi) + 0.5 * (x_hi - x_lo) * u


def cheb_fit(values: torch.Tensor) -> torch.Tensor:
    """Chebyshev coefficients from values at the cheb_nodes points (last
    axis), through the DCT matrix."""
    f = _cheb_tables_on(values.shape[-1], values.device)[1]
    return torch.matmul(values, f.T)


@functools.lru_cache(maxsize=None)
def _deriv_matrix(n: int, device: torch.device) -> torch.Tensor:
    """D (n, n) with Σ_k (D c)_k T_k = d/du Σ_j c_j T_j: (D c)_k =
    (2 − δ_k0)·Σ_{j>k, j−k odd} j·c_j."""
    j = np.arange(n)
    odd = (j[None, :] > j[:, None]) & ((j[None, :] - j[:, None]) % 2 == 1)
    d = np.where(odd, 2.0 * j[None, :], 0.0)
    d[0] *= 0.5
    return torch.as_tensor(d.astype(np.float32), device=device)


def cheb_basis(u: torch.Tensor, n: int) -> torch.Tensor:
    """T_0(u) … T_{n−1}(u) on a new last axis, by the three-term
    recurrence."""
    u2 = 2.0 * u
    t = [torch.ones_like(u), u]
    for _ in range(2, n):
        t.append(u2 * t[-1] - t[-2])
    return torch.stack(t[:n], -1)


def cheb_deriv_coef(coef: torch.Tensor) -> torch.Tensor:
    """The coefficients (..., n) of d/du Σ_j coef_j T_j(u)."""
    dmat = _deriv_matrix(coef.shape[-1], coef.device)
    return coef @ dmat.to(coef.dtype).T


class ChebSeries(torch.autograd.Function):
    """sum_j coef[..., j] T_j(u), coef (..., n) broadcasting against u (...).

    The forward builds the basis T_0(u) … T_{n−1}(u) (``cheb_basis``) and
    sums it against coef; it keeps the basis, so the backward is a few
    tensor operations: ∂/∂coef_j = T_j(u), and ∂/∂u is the derivative
    series (``cheb_deriv_coef``) on the same basis.  Autograd then records
    one node per evaluation instead of several per term: the evaluations
    sit in every step of the un-hoisted Chebyshev and hoisted paths, whose
    loops are bound by the cost per operation at small batches."""

    @staticmethod
    def forward(ctx, coef, u):
        basis = cheb_basis(u, coef.shape[-1])
        ctx.save_for_backward(coef, basis)
        return (basis * coef).sum(-1)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        coef, basis = ctx.saved_tensors
        grad_coef = grad_u = None
        if ctx.needs_input_grad[0]:
            grad_coef = (g[..., None] * basis).sum_to_size(coef.shape)
        if ctx.needs_input_grad[1]:
            grad_u = (g * (basis * cheb_deriv_coef(coef)).sum(-1)
                      ).sum_to_size(basis.shape[:-1])
        return grad_coef, grad_u


def cheb_series(coef: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """sum_j coef[..., j] T_j(u), differentiable in both (``ChebSeries``)."""
    return ChebSeries.apply(coef, u)


def cheb_eval(coef: torch.Tensor, x: torch.Tensor, x_lo: torch.Tensor,
              x_hi: torch.Tensor) -> torch.Tensor:
    """sum_j coef_j T_j(u(x)); x outside [x_lo, x_hi] clamps."""
    x_lo, x_hi = x_lo.detach(), x_hi.detach()
    span = torch.clamp(x_hi - x_lo, min=1e-6)
    u = torch.clamp((2.0 * x - (x_lo + x_hi)) / span, -1.0, 1.0)
    return cheb_series(coef, u)


def _range_of(x: torch.Tensor, robust_sigmas) -> tuple:
    """Collocation interval: full [min, max], or mean ± k·std intersected
    with it (for heavy-tailed path laws)."""
    x_lo, x_hi = x.min(), x.max()
    if robust_sigmas is not None:
        mu, sd = x.mean(), x.std(unbiased=False)
        x_lo = torch.maximum(x_lo, mu - robust_sigmas * sd)
        x_hi = torch.minimum(x_hi, mu + robust_sigmas * sd)
    return x_lo, x_hi


def interp_1d(fn, x: torch.Tensor, n: int, robust_sigmas=None) -> torch.Tensor:
    """Approximate the smooth 1-D ``fn`` on the range of ``x`` by its
    degree-(n-1) Chebyshev interpolant: n calls of ``fn``, O(n) per path."""
    x_lo, x_hi = _range_of(x, robust_sigmas)
    nodes = cheb_nodes(x_lo, x_hi, n)
    coef = cheb_fit(fn(nodes))
    return cheb_eval(coef, x, x_lo, x_hi)
