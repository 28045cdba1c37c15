"""Bias-free multiplicative-walk update, the port's f32 policy, and TF32
operand rounding.

``mul_exp(x, u)`` computes ``x·e^u`` as ``x + x·expm1_acc(u)``: the identity
part of the factor is carried exactly, and ``expm1_acc`` is a degree-7 Taylor
polynomial in exactly-rounded f32 multiplies and adds on |u| < 0.125 with an
``exp(u) − 1`` fallback beyond.  An N-step walk ``X ← X·exp(u_i)`` then keeps
its martingale property down to f32 rounding, whatever the bias of the
platform's ``exp`` near 0.  The CUDA rollout kernels use the same
polynomial as ``__device__`` functions (``csrc/rollout_common.cuh``).

``tf32_matmul`` is a product whose operands are rounded to TF32 first, in
its forward and in both products of its backward: what one TF32 pass of the
tensor cores computes (the products of two TF32 values are exact in f32,
the sums stay f32).  It is the plain version of the fused rollout kernels'
head-TF32 mode (``csrc/rollout_common.cuh`` ``tf32_round``).
"""

from __future__ import annotations

import contextlib

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


@contextlib.contextmanager
def tf32_allowed(on: bool = True):
    """A scope in which the card's f32 matmuls may run in TF32 (``on``), the
    flag restored on exit; on the CPU it changes nothing."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 ``x`` rounded to TF32 (10 mantissa bits, to nearest, ties away
    from zero) on its int32 view, as the kernels' ``tf32_round`` does: add
    half a unit of the 13 dropped bits, then clear them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


class _Tf32Matmul(torch.autograd.Function):
    """a·b on operands rounded to TF32; the cotangent is rounded too before
    each product of the backward, as a TF32 pass would take it."""

    @staticmethod
    def forward(ctx, a, b):
        ar, br = tf32_round(a), tf32_round(b)
        ctx.save_for_backward(ar, br)
        return torch.matmul(ar, br)

    @staticmethod
    def backward(ctx, g):
        ar, br = ctx.saved_tensors
        gr = tf32_round(g)
        ga = torch.matmul(gr, br.transpose(-1, -2))
        gb = torch.matmul(ar.transpose(-1, -2), gr)
        return ga, gb.reshape(-1, *gb.shape[-2:]).sum(0)


def tf32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` for a (..., K) batch of rows and a (K, M) matrix, both
    operands rounded to TF32, f32 sums; differentiable as a TF32 product."""
    return _Tf32Matmul.apply(a, b)


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
