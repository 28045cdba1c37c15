"""A hand-written adjoint for the hoisted global rollout (``adjoint=True``).

The rollout of the global jump-diffusion scheme on the fully hoisted
piecewise path (the compensator, the price and Z read from per-step
tables) is, per step,

    y_{i+1} = y_i − dt·f(y_i) + Γ_i(x_i) − C_i(x_i) + Z_i(x_i)·dW_i
    x_{i+1} = x_i·E_i + φ(y_{i+1} − A_i(x_i))·dt,   E_i = e^{drift + σdW_i + J_i}

and its adjoint recurrence is linear in the adjoints, with coefficients
that depend on the forward trajectory alone:

    ū_i = x̄_{i+1}·φ'(u_i)·dt,   ḡ_i = ȳ_{i+1} + ū_i
    x̄_i = x̄_{i+1}·E_i − ḡ_i·C'_i + ḡ_i·dW_i·Z'_i − ū_i·A'_i + ḡ_i·∂xΓ_i
    ȳ_i = ḡ_i·(1 − dt·f'(y_i))

So the backward recomputes every coefficient in one batched pass over all
N·B saved states (the Γ head's value and ∂x by autograd, the tables'
derivatives by ``pw_eval_with_deriv``), runs the recurrence as a reverse
loop of elementwise updates, and takes the parameter and table cotangents
in one more batched pass: the head's VJP with the ḡ_i, and per step the
one-hot products one_hot(k)ᵀ·(T(t)·w) of the tables (no float atomics).
The forward keeps two (N, B) trajectories, x_i and y_{i+1}.  It is the
JAX package's ``solvers/adjoint.py`` written in PyTorch; there it is XLA,
not a Pallas kernel, and here it is plain PyTorch, no kernel.

The forward is the loop of the solver's own hoisted path (``ops/rollout.py``
``rollout_plain``, which ``PricingSolver._global_hoisted`` runs too), so the
loss is the autograd path's loss bit for bit; the gradients agree with
autograd's to f32 rounding.
"""

from __future__ import annotations

from typing import Callable

import torch

from deepfbsdejsolvers_torch.ops.chebyshev import cheb_basis, cheb_deriv_coef
from deepfbsdejsolvers_torch.ops.numerics import expm1_acc
from deepfbsdejsolvers_torch.ops.rollout import rollout_plain


def _rows(coef, x, lo, hi):
    """Every step's table at once: (value, d/dx value, piece index, basis
    T_0..T_{D-1}(t)) at x (N, B) for coef (N, P, D) on [lo_i, hi_i], as
    ``pw_eval_with_deriv`` evaluates one step."""
    p, d = coef.shape[-2], coef.shape[-1]
    lo, hi = lo.detach()[:, None], hi.detach()[:, None]
    span = torch.clamp(hi - lo, min=1e-6)
    s_raw = (x - lo) / span
    s = torch.clamp(s_raw, 0.0, 1.0) * p
    k = torch.clamp(torch.floor(s), 0, p - 1).long()
    t = 2.0 * (s - k) - 1.0
    rows = torch.arange(coef.shape[0], device=x.device)[:, None]
    c = coef[rows, k]                                      # (N, B, D)
    basis = cheb_basis(t, d)
    val = (basis * c).sum(-1)
    dval = (basis * cheb_deriv_coef(c)).sum(-1)
    inside = ((s_raw >= 0.0) & (s_raw <= 1.0)).to(x.dtype)
    return val, dval * (2.0 * p / span) * inside, k, basis


def _table_cotangent(k, basis, w, n_pieces: int):
    """The cotangent (N, P, D) of a table evaluated at pieces k (N, B) with
    bases (N, B, D), cotangents w (N, B): per step one_hot(k)ᵀ·(T·w)."""
    onehot = (k[..., None] == torch.arange(n_pieces, device=k.device)).to(
        basis.dtype)                                       # (N, B, P)
    return torch.bmm(onehot.transpose(1, 2), basis * w[..., None])


class _GlobalAdjoint(torch.autograd.Function):
    """(x_N, y_N) of the hoisted rollout; its backward is the recurrence of
    the module docstring."""

    @staticmethod
    def forward(ctx, roll, y0, cc, pc, zc, lo, hi, dw, j, *leaves):
        gam = roll.params(leaves)
        x, y, xs, ys = roll.forward(gam, y0, cc, pc, zc, lo, hi, dw, j)
        ctx.roll = roll
        ctx.save_for_backward(y0, cc, pc, zc, lo, hi, dw, j, xs, ys, *leaves)
        return x, y

    @staticmethod
    def backward(ctx, gxn, gyn):
        roll = ctx.roll
        y0, cc, pc, zc, lo, hi, dw, j, xs, ys, *leaves = ctx.saved_tensors
        model, dt = roll.model, roll.model.dt
        n, batch = dw.shape
        gxn = torch.zeros_like(xs[0]) if gxn is None else gxn
        gyn = torch.zeros_like(xs[0]) if gyn is None else gyn
        steps = torch.arange(n, device=dw.device)[:, None]
        p = cc.shape[-2]
        # the one batched pass: the coefficients of every (i, b)
        e_fac = 1.0 + expm1_acc(model.uncoupled_log_increments(dw, j))
        _, cps, kc, basis = _rows(cc.detach(), xs, lo, hi)
        a_vals, aps, _, _ = _rows(pc.detach(), xs, lo, hi)
        _, zps, _, _ = _rows(zc.detach(), xs, lo, hi)
        with torch.enable_grad():
            u = (ys - a_vals).requires_grad_(True)
            (phip,) = torch.autograd.grad(model.coupling(u).sum(), u)
            y_prev = torch.cat([y0.detach() * torch.ones_like(ys[:1]),
                                ys[:-1]]).requires_grad_(True)
            (fp,) = torch.autograd.grad(model.f(y_prev).sum(), y_prev)
            params = roll.params([t.detach().requires_grad_(True)
                                  for t in leaves])
            xl = xs.detach().requires_grad_(True)
            head = roll.apply_gam(params, steps, xl, j)
            (gx,) = torch.autograd.grad(head.sum(), xl, retain_graph=True)
        # the reverse loop of elementwise updates
        xb, yb = gxn, gyn
        gbars, ubars = [None] * n, [None] * n
        for i in range(n - 1, -1, -1):
            ub = xb * phip[i] * dt
            yb = yb + ub
            xb = xb * e_fac[i]
            gbar = yb
            xb = (xb - gbar * cps[i] + gbar * dw[i] * zps[i] - ub * aps[i]
                  + gbar * gx[i])
            yb = yb * (1.0 - dt * fp[i])
            gbars[i], ubars[i] = gbar, ub
        gbars, ubars = torch.stack(gbars), torch.stack(ubars)
        # the parameter and table cotangents, batched over (N, B)
        head_grads = torch.autograd.grad(head, roll.leaves(params), gbars)
        dcc = _table_cotangent(kc, basis, -gbars, p)
        dzc = _table_cotangent(kc, basis, gbars * dw, p)
        dpc = _table_cotangent(kc, basis, -ubars, p)
        return (None, torch.sum(yb).reshape(y0.shape), dcc, dpc, dzc, None,
                None, None, None, *head_grads)


class GlobalAdjointRollout:
    """``rollout(gam_params, y0, tables, dw, j) -> (x_N, y_N)`` with
    ``tables = {"cc", "pc", "zc", "lo", "hi"}`` (piecewise (N, P, D) and
    (N,)), differentiated by the hand-written adjoint."""

    def __init__(self, model, apply_gam: Callable):
        self.model = model
        self.apply_gam = apply_gam

    @staticmethod
    def leaves(gam_params) -> list:
        return [*gam_params["W"], *gam_params["b"]]

    def params(self, leaves) -> dict:
        half = len(leaves) // 2
        return {"W": list(leaves[:half]), "b": list(leaves[half:])}

    def forward(self, gam, y0, cc, pc, zc, lo, hi, dw, j):
        """(x_N, y_N, xs, ys): ``rollout_plain``'s loop with this rollout's
        Γ, x_i before and y_{i+1} after each step's update kept."""
        tables = {"cc": cc, "pc": pc, "zc": zc, "lo": lo, "hi": hi}
        return rollout_plain(
            self.model, None, y0, tables, dw, j, residuals=True,
            gamma=lambda i, x, ji: self.apply_gam(gam, i, x, ji))

    def __call__(self, gam_params, y0, tables, dw, j):
        return _GlobalAdjoint.apply(
            self, y0, tables["cc"], tables["pc"], tables["zc"], tables["lo"],
            tables["hi"], dw, j, *self.leaves(gam_params))


def make_global_adjoint_rollout(model, apply_gam: Callable
                                ) -> GlobalAdjointRollout:
    """The hand-adjoint rollout of ``model``: ``apply_gam(gam_params, i, x,
    j) -> Γ`` must broadcast a step index i (an int, or (N, 1)) against x
    and j ((B,) or (N, B)), as ``PricingSolver._gamma_head`` does."""
    return GlobalAdjointRollout(model, apply_gam)
