"""B2's head-TF32 instance at H = 8 and 21, its sums emulated on the CPU.

In the head-TF32 mode (``fused_head_precision="default"``) the specialised
B2 (``csrc/rollout_bwd.cu``, template flag TF) recomputes the Γ head's
second layer on h1 and W2 rounded to TF32 and runs the head's backward on
dp2 = W3·ḡ·(1 − h2²) rounded to TF32 once, where each thread stages it:
W2·dp2 from its registers and the sum over paths h1ᵀ·dp2 (dW2) from the
staged rows, h1 staged rounded too, every product of two TF32 values exact
in f32.  db2 is summed apart from the unrounded dp2: per step a shuffle
tree over each warp's 32 paths (``warp_sum8``: the lanes paired across
bit 16, then 8, 4, 2 and 1), which the kernel adds into a register per
warp, the warps summed in order at the end.  Here the hoisted Merton
rollout of ``ops/rollout.py`` (``rollout_plain`` with the Γ head spliced in
through its ``gamma`` hook) runs with a head whose backward takes those
sums (``B2Tf32Head``; the warps' sums added per step, where the kernel adds
each warp's steps first), and its loss and gradient are held to the TF32
plain version's (``rollout_plain(..., head_tf32=True)``, autograd of
``gamma_head``) within the tolerance ``chip_smoke.py`` holds B2 to on the
card: 1e-4 relative, for the gradient's global norm and for each leaf (W1,
W2, W3, b1, b2, b3, y0 and the three tables).  The plain version's db2 is
the sum over paths of the unrounded dp2, which is why the kernel sums it
apart.  The inputs are the speed configuration's (``fused_rollout=True``):
N = 50 steps, 1024 paths, a Γ head of seeded weights with non-zero biases,
the hoisted piecewise tables of its own noise."""

import pytest
import torch

from deepfbsdejsolvers_torch.ops.numerics import tf32_matmul, tf32_round
from deepfbsdejsolvers_torch.ops.rollout import gamma_head, rollout_plain
from test_torch_rollout_split import GRAD_TOL, LEAVES, _leaves, case
from test_torch_rollout_tf32 import first_layer_tf32, mm_plain_tf32

WARP = 32


def warp_tree_sum(v: torch.Tensor) -> torch.Tensor:
    """Σ over the rows of (B, H) ``v`` as B2 sums db2: the rows in warps of
    32 paths (the ragged last warp's idle paths zero), each warp's by the
    shuffle tree of ``warp_sum8`` (row m paired with m + 16, then the
    partial sums with those 8, 4, 2 and 1 apart), the warps' sums added in
    order."""
    pad = -v.shape[0] % WARP
    w = torch.nn.functional.pad(v, (0, 0, 0, pad)).reshape(-1, WARP,
                                                             v.shape[1])
    half = WARP
    while half > 1:
        half //= 2
        w = w[:, :half] + w[:, half:2 * half]
    total = w[0, 0]
    for k in range(1, w.shape[0]):
        total = total + w[k, 0]
    return total


class B2Tf32Head(torch.autograd.Function):
    """h1 ↦ tanh(tf32(h1)·tf32(W2) + b2)·W3, the TF32 plain version's
    forward; its backward as B2's head-TF32 instance sums it: the second
    layer recomputed on rounded operands, dp2 rounded once, W2·dp2 and
    h1ᵀ·dp2 on rounded operands, db2 the warps' shuffle trees over the
    unrounded dp2."""

    @staticmethod
    def forward(ctx, h1, w2, b2, w3):
        ctx.save_for_backward(h1, w2, b2, w3)
        return torch.matmul(torch.tanh(mm_plain_tf32(h1, w2) + b2), w3)

    @staticmethod
    def backward(ctx, g):
        h1, w2, b2, w3 = ctx.saved_tensors
        h2 = torch.tanh(mm_plain_tf32(h1, w2) + b2)
        raw = (w3[:, 0] * g) * (1.0 - h2 * h2)
        dp2 = tf32_round(raw)
        return (torch.matmul(dp2, tf32_round(w2).T),
                torch.matmul(tf32_round(h1).T, dp2), warp_tree_sum(raw),
                torch.matmul(h2.T, g))


def emulated_gamma(gam):
    (w1, w2, w3), (b1, b2, b3) = gam["W"], gam["b"]

    def gamma(i, x, ji):
        h1 = first_layer_tf32(w1, b1, torch.full_like(x, float(i)), x, ji)
        return (B2Tf32Head.apply(h1, w2, b2, w3) + b3)[..., 0]
    return gamma


def loss_and_grads(h: int, emulate: bool):
    """The speed loss at hidden ``h`` and its gradient over ``LEAVES``,
    the head's backward B2 TF's (``emulate``) or autograd's of the TF32
    plain version."""
    model, gam, y0, tables, dw, j = case(h)
    leaves, g, y, tabs = _leaves(gam, y0, tables, torch.float32)
    kw = {"gamma": emulated_gamma(g)} if emulate else {"head_tf32": True}
    xn, yn = rollout_plain(model, g, y, tabs, dw, j, **kw)
    loss = torch.mean(torch.square(yn - model.payoff(xn)))
    return loss, torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("h", [8, 21])
def test_b2_tf32_sums_hold_the_plain_gradient(h):
    """db2 of the TF32 plain version is the sum of the unrounded dp2 (and
    not of the rounded one); B2 TF's sums (dp2 rounded once where staged,
    db2 apart by warp trees of the raw dp2) give the plain version's loss
    bit for bit and its gradient within 1e-4, whole and per leaf."""
    gen = torch.Generator().manual_seed(h)
    w1, w2, w3 = (torch.randn(s, generator=gen) for s in ((3, h), (h, h),
                                                          (h, 1)))
    b1, b2, b3 = (0.1 * torch.randn(s, generator=gen) for s in (h, h, 1))
    cols = torch.randn(300, 3, generator=gen)
    g = torch.randn(300, 1, generator=gen)
    b2.requires_grad_(True)
    out = gamma_head({"W": [w1, w2, w3], "b": [b1, b2, b3]}, cols,
                     head_tf32=True)
    (db2,) = torch.autograd.grad(out, [b2], g)
    c = cols[..., None]
    h1 = torch.tanh(c[:, 0] * w1[0] + c[:, 1] * w1[1] + c[:, 2] * w1[2] + b1)
    z = (tf32_matmul(h1, w2) + b2).detach().requires_grad_(True)
    rebuilt = torch.matmul(torch.tanh(z), w3) + b3
    assert torch.equal(rebuilt, out)
    (dp2,) = torch.autograd.grad(rebuilt, [z], g)
    assert torch.equal(db2, dp2.sum(0))
    assert not torch.equal(db2, tf32_round(dp2).sum(0))

    lk, gk = loss_and_grads(h, emulate=True)
    lp, gp = loss_and_grads(h, emulate=False)
    assert torch.equal(lk, lp)
    leaf = {n: float((a.double() - b.double()).norm() / b.double().norm())
            for n, a, b in zip(LEAVES, gk, gp)}
    num = sum(float(((a.double() - b.double()) ** 2).sum())
              for a, b in zip(gk, gp))
    den = sum(float((b.double() ** 2).sum()) for b in gp)
    assert (num / den) ** 0.5 <= GRAD_TOL, leaf
    assert max(leaf.values()) <= GRAD_TOL, leaf
