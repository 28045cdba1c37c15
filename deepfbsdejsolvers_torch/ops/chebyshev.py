"""Chebyshev collocation of a 1-D smooth function of the spot.

``comp(x) = E_J[Γ(t, x, J)]`` and the Merton price A(i, x) are smooth
functions of x alone, so they are evaluated exactly at n Chebyshev points
spanning the batch's spot range, fitted by a DCT matrix, and reconstructed per
path with a Clenshaw recurrence.  The interval endpoints are detached: the
interval is a numerical device, not part of the function differentiated.
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


def cheb_eval(coef: torch.Tensor, x: torch.Tensor, x_lo: torch.Tensor,
              x_hi: torch.Tensor) -> torch.Tensor:
    """sum_j coef_j T_j(u(x)) by Clenshaw; x outside [x_lo, x_hi] clamps."""
    x_lo, x_hi = x_lo.detach(), x_hi.detach()
    span = torch.clamp(x_hi - x_lo, min=1e-6)
    u = torch.clamp((2.0 * x - (x_lo + x_hi)) / span, -1.0, 1.0)
    n = coef.shape[-1]
    b1 = torch.zeros_like(u)
    b2 = torch.zeros_like(u)
    for j in range(n - 1, 0, -1):
        b1, b2 = coef[..., j] + 2.0 * u * b1 - b2, b1
    return coef[..., 0] + u * b1 - b2


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
