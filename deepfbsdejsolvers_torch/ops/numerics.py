"""Bias-free multiplicative-walk update, and the port's f32 policy.

``mul_exp(x, u)`` computes ``x·e^u`` as ``x + x·expm1_acc(u)``: the identity
part of the factor is carried exactly, and ``expm1_acc`` is a degree-7 Taylor
polynomial in exactly-rounded f32 multiplies and adds on |u| < 0.125 with an
``exp(u) − 1`` fallback beyond.  An N-step walk ``X ← X·exp(u_i)`` then keeps
its martingale property down to f32 rounding, whatever the bias of the
platform's ``exp`` near 0.  The CUDA rollout kernels use the same
polynomial as ``__device__`` functions (``csrc/rollout_common.cuh``).
"""

from __future__ import annotations

import torch

# Degree-7 Taylor radius: |u| < 1/8 keeps the truncation term u^7/8! below
# 1.3e-11 relative while covering almost all the mass of every shipped
# increment law (Merton default: std ≈ σ√dt ≈ 0.042 at N=50).
_TAYLOR_CUT = 0.125


def use_full_f32() -> None:
    """Full-f32 matmuls and convolutions on the card: TF32 keeps about three
    decimal digits, far too few for the parity tolerances (1e-5 on the loss)
    and for the piecewise table fits."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def expm1_taylor7(u: torch.Tensor) -> torch.Tensor:
    """Degree-7 Horner expm1: u·(1 + u/2·(1 + u/3·(⋯(1 + u/7))))."""
    p = u / 7.0
    for k in (6.0, 5.0, 4.0, 3.0, 2.0):
        p = (1.0 + p) * u / k
    return u * (1.0 + p)


def expm1_acc(u: torch.Tensor) -> torch.Tensor:
    """Accurate e^u − 1: Taylor on |u| < 0.125, exp(u) − 1 beyond."""
    return torch.where(u.abs() < _TAYLOR_CUT, expm1_taylor7(u),
                       torch.exp(u) - 1.0)


def mul_exp(x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """x·e^u with the identity part of the factor carried exactly;
    differentiable in both arguments."""
    return x + x * expm1_acc(u)
