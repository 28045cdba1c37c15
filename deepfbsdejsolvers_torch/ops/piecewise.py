"""Piecewise Chebyshev collocation: P pieces × local degree-(D-1) series.

The same 64 degrees of freedom as a global degree-63 Chebyshev interpolant,
arranged as P=8 local degree-7 series, evaluate in a piece lookup plus a
degree-7 series per path (in the CUDA kernels by Clenshaw's recurrence, here
as the sum of its basis, ``chebyshev.cheb_series``).  Per piece the
function is sampled at D Chebyshev points and the local Chebyshev
coefficients come from the inverse of the collocation matrix T_k(t_i),
which is sqrt(2)-conditioned at every degree.

The per-path piece select (``select_rows``) is the JAX package's one-hot
matmul written as an autograd function: its forward gathers ``coef[k]``,
so every selected coefficient keeps its bits, and its backward is the
one-hot product one_hot(k)ᵀ·ḡ, a (P × B)·(B × D) matmul, so the cotangent
of the table is summed in a fixed order (no float atomics: PyTorch's own
gather backward accumulates with atomics on the card, serialised over the
few pieces).  Piece index and interval ends are detached; points outside
the interval clamp to its boundary, with derivative 0 past the edge.

The 2-D tables of ``pw2_*`` (the Γ head's hoisted tables over (x, J),
``PricingSolver(hoist_gamma=True)``) are tensor products of the same local
series: Px × Pj piece pairs, each (Dx + 1)·(Dj + 1) coefficients fitted by
the two 1-D collocation inverses along their axes, and evaluated by a
nested Clenshaw after ``select_rows`` picks the pair's row, so their
backward too is the deterministic one-hot product.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from deepfbsdejsolvers_torch.ops.chebyshev import (
    cheb_basis, cheb_deriv_coef, cheb_series)


@functools.lru_cache(maxsize=None)
def _pw_tables(n_pieces: int, degree: int):
    """Sample points (P*D,) in the global [0, 1] coordinate: D Chebyshev
    points per piece."""
    d = degree + 1
    k = np.arange(d)
    t_loc = -np.cos(np.pi * (k + 0.5) / d)
    pieces = np.arange(n_pieces)
    t_glob = ((pieces[:, None] + 0.5 * (t_loc[None, :] + 1.0))
              / n_pieces).reshape(-1)
    return t_glob.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _pw_cheb_fit(degree: int):
    """Values-at-Chebyshev-points -> local Chebyshev coefficients map (D, D)."""
    d = degree + 1
    k = np.arange(d)
    t_loc = -np.cos(np.pi * (k + 0.5) / d)
    T = np.cos(np.arange(d)[None, :] * np.arccos(np.clip(t_loc[:, None],
                                                         -1.0, 1.0)))
    return np.linalg.inv(T).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _nodes_on(n_pieces: int, degree: int, device: torch.device):
    """``_pw_tables`` on ``device``, copied once per device."""
    return torch.as_tensor(_pw_tables(n_pieces, degree), device=device)


@functools.lru_cache(maxsize=None)
def _fit_on(degree: int, device: torch.device):
    """``_pw_cheb_fit`` on ``device``, copied once per device."""
    return torch.as_tensor(_pw_cheb_fit(degree), device=device)


def pw_nodes(x_lo: torch.Tensor, x_hi: torch.Tensor, n_pieces: int,
             degree: int) -> torch.Tensor:
    """Sample points on [x_lo, x_hi] (last axis, P*D points); ends detached."""
    t = _nodes_on(n_pieces, degree, x_lo.device)
    x_lo, x_hi = x_lo.detach(), x_hi.detach()
    return x_lo[..., None] + (x_hi - x_lo)[..., None] * t


def pw_fit(values: torch.Tensor, n_pieces: int, degree: int) -> torch.Tensor:
    """Local Chebyshev coefficients (..., P, D) from values at the pw_nodes
    points (..., P*D)."""
    d = degree + 1
    fit = _fit_on(degree, values.device)
    v = values.reshape(values.shape[:-1] + (n_pieces, d))
    return torch.matmul(v, fit.T)


class _SelectRows(torch.autograd.Function):
    """rows = coef[k] for coef (P, D) and piece indices k (int64, any
    shape); the cotangent of coef is one_hot(k)ᵀ·ḡ."""

    @staticmethod
    def forward(ctx, coef, k):
        ctx.save_for_backward(k)
        ctx.n_pieces = coef.shape[-2]
        return coef[k]

    @staticmethod
    def backward(ctx, g):
        (k,) = ctx.saved_tensors
        p, d = ctx.n_pieces, g.shape[-1]
        pieces = torch.arange(p, device=k.device)
        onehot = (k.reshape(-1, 1) == pieces).to(g.dtype)
        return onehot.T @ g.reshape(-1, d), None


def select_rows(coef: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """coef[k] (the per-path coefficient rows of piece indices ``k``), with
    the deterministic one-hot backward of ``_SelectRows``."""
    return _SelectRows.apply(coef, k)


def _locate(coef: torch.Tensor, x: torch.Tensor, x_lo: torch.Tensor,
            x_hi: torch.Tensor):
    """(per-path coefficient rows (B, D), local t, s_raw, span)."""
    p = coef.shape[-2]
    x_lo, x_hi = x_lo.detach(), x_hi.detach()
    span = torch.clamp(x_hi - x_lo, min=1e-6)
    s_raw = (x - x_lo) / span
    s = torch.clamp(s_raw, 0.0, 1.0) * p
    k = torch.clamp(torch.floor(s), 0, p - 1).detach()
    t = 2.0 * (s - k) - 1.0
    return select_rows(coef, k.long()), t, s_raw, span


def pw_eval(coef: torch.Tensor, x: torch.Tensor, x_lo: torch.Tensor,
            x_hi: torch.Tensor) -> torch.Tensor:
    """Evaluate one step's piecewise interpolant: coef (P, D), x (B,),
    x_lo/x_hi scalars."""
    c, t, _, _ = _locate(coef, x, x_lo, x_hi)
    return cheb_series(c, t)


def pw_eval_with_deriv(coef: torch.Tensor, x: torch.Tensor,
                       x_lo: torch.Tensor, x_hi: torch.Tensor):
    """(value, d/dx value) sharing one select; the derivative is 0 where x
    is clamped, as autograd of pw_eval gives."""
    p = coef.shape[-2]
    c, t, s_raw, span = _locate(coef, x, x_lo, x_hi)
    basis = cheb_basis(t, c.shape[-1])
    val = (basis * c).sum(-1)
    dval = (basis * cheb_deriv_coef(c)).sum(-1)
    inside = ((s_raw >= 0.0) & (s_raw <= 1.0)).to(x.dtype)
    return val, dval * (2.0 * p / span) * inside


def pw2_nodes(x_lo, x_hi, j_lo, j_hi, px: int, dx: int, pj: int, dj: int):
    """(xn (..., px·(dx+1)), jn (..., pj·(dj+1))): the sample points of a
    2-D piecewise fit on [x_lo, x_hi] × [j_lo, j_hi]; the caller evaluates
    the target on the outer product of the two."""
    return pw_nodes(x_lo, x_hi, px, dx), pw_nodes(j_lo, j_hi, pj, dj)


def pw2_fit(values: torch.Tensor, px: int, dx: int, pj: int,
            dj: int) -> torch.Tensor:
    """Local 2-D Chebyshev coefficients (..., px·pj, (dx+1)·(dj+1)) from
    values on the ``pw2_nodes`` grid (..., px·(dx+1), pj·(dj+1)): row
    kx·pj + kj is piece pair (kx, kj), column a·(dj+1) + b the coefficient
    of T_a(t_x)·T_b(t_j)."""
    ddx, ddj = dx + 1, dj + 1
    fx = _fit_on(dx, values.device)
    fj = _fit_on(dj, values.device)
    lead = values.shape[:-2]
    v = values.reshape(*lead, px, ddx, pj, ddj)
    v = torch.einsum("...aibj,xi->...abxj", v, fx)
    v = torch.einsum("...abxj,yj->...abxy", v, fj)
    return v.reshape(*lead, px * pj, ddx * ddj)


def _clenshaw(c: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Σ_k c[..., k]·T_k(t) by Clenshaw's recurrence."""
    b1 = torch.zeros_like(c[..., 0])
    b2 = b1
    for k in range(c.shape[-1] - 1, 0, -1):
        b1, b2 = c[..., k] + 2.0 * t * b1 - b2, b1
    return c[..., 0] + t * b1 - b2


def _piece_of(v, lo, hi, p: int):
    """(piece index, local t) of v on [lo, hi] split into p pieces, v
    clamped to the interval, the ends and the index detached."""
    lo, hi = lo.detach(), hi.detach()
    s = torch.clamp((v - lo) / torch.clamp(hi - lo, min=1e-6), 0.0, 1.0) * p
    k = torch.clamp(torch.floor(s), 0, p - 1).detach()
    return k, 2.0 * (s - k) - 1.0


def pw2_eval(coef: torch.Tensor, x: torch.Tensor, j: torch.Tensor, x_lo,
             x_hi, j_lo, j_hi, px: int, dx: int, pj: int,
             dj: int) -> torch.Tensor:
    """One step's 2-D interpolant at (x, j) (both (B,)): coef (px·pj,
    (dx+1)·(dj+1)) from ``pw2_fit``.  The pair's row is selected by
    ``select_rows``; a Clenshaw in t_j for each x degree, then one in t_x.
    Points outside the rectangle clamp to its edge."""
    kx, tx = _piece_of(x, x_lo, x_hi, px)
    kj, tj = _piece_of(j, j_lo, j_hi, pj)
    c = select_rows(coef, (kx * pj + kj).long())
    c = c.reshape(c.shape[:-1] + (dx + 1, dj + 1))
    return _clenshaw(_clenshaw(c, tj[..., None]), tx)
