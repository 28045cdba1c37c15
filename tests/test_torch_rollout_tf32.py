"""The head-TF32 instances of the wide rollout kernels, emulated on the CPU.

In the head-TF32 mode (``fused_head_precision="default"``) the wide B1 and
B2 (``csrc/rollout_wide_fwd.cu``, ``csrc/rollout_wide_bwd.cu``) take every
operand of the Γ head's H×H products rounded to TF32
(``ops/numerics.tf32_round``), so each product of two operands is exact in
f32.  B2w runs its three products (the recomputed h1·W2, dp2·W2ᵀ and the
sum over paths h1ᵀ·dp2, per 128-path tile, the tiles added in order) in
one TF32 pass on the tensor cores: ``mma.sync`` m16n8k8 adds the eight
exact products of a k-step into its f32 accumulator at once.  B1w sums
h1·W2 in the plain version's order (one f32 FMA a term, from zero).  Here
each k-step's exact sum is added to an f32 running sum from zero and
rounded once, to nearest or truncated toward zero (``mm_steps``; published
measurements of NVIDIA's tensor cores find their sums truncated), inside
the hoisted Merton rollout of ``ops/rollout.py`` (``rollout_plain`` with
the Γ head spliced in through its ``gamma`` hook, the first layer summed
as ``first_sum_tf32`` sums it).  The loss and each gradient leaf are held
to the TF32 plain version (``rollout_plain(..., head_tf32=True)``, its
products summed by the CPU's matmul) and to a float64 evaluation of the
same TF32 arithmetic (the operands rounded to TF32 as f32, everything else
in float64), within the tolerances ``chip_smoke.py`` holds the kernels to
on the card: the loss to 1e-5 relative, each leaf (W1, W2, W3, b1, b2,
b3, y0 and the three tables) and their global norm to 1e-4 relative.
Paths whose two trajectories straddle a discontinuity of the gradient get
no weight in either loss, as in ``check_wide_grads``, and they must be
fewer than 1%.

Why B1w's TF32 instance keeps the plain order: on the card its product on
the tensor cores missed the B1 + B2 check at hidden 20 (global 1.02e-4,
the y0 leaf 2.9e-4, tolerance 1e-4; header of ``csrc/rollout_wide_fwd.cu``).
At step 0 the paths share x0 and mostly J = 0, so they share h1, and any
summation of h1·W2 other than the plain version's shifts their y alike;
the loss's gradient, a sum over paths of (y_N − g(x_N)) times the paths'
sensitivities that largely cancels, magnifies such a shift.  A sum that
rounds to nearest by k-steps of 8 stays within the tolerance here; one
that truncates, shifting every path's Z toward zero, misses.  The inputs
are the speed configuration's (``fused_rollout=True``): N = 50 steps,
1024 paths, a Γ head of seeded weights with non-zero biases at hidden 20,
64 and 128, the hoisted piecewise tables of its own noise."""

import functools
import math

import pytest
import torch

from deepfbsdejsolvers_torch.ops import rollout as R
from deepfbsdejsolvers_torch.ops.numerics import tf32_round
from deepfbsdejsolvers_torch.ops.rollout import rollout_plain
from test_torch_rollout_split import (BATCH, GRAD_TOL, LEAVES, LOSS_TOL,
                                      KernelHead, _float64_model, _leaves,
                                      case, straddling)

TILE = 128


def round_f32(v: torch.Tensor, truncate: bool) -> torch.Tensor:
    """float64 ``v`` to f32: to nearest, or toward zero."""
    f = v.float()
    if not truncate:
        return f
    over = f.double().abs() > v.abs()
    return torch.where(over, torch.nextafter(f, torch.zeros_like(f)), f)


def mm_steps(a, b, k: int = 8, truncate: bool = False):
    """a @ b for (M, K) and (K, N) f32 operands rounded to TF32 first, as a
    TF32 pass of ``mma.sync`` m16n8k8 sums it (k = 8): K zero-padded to
    whole k-steps, each k-step's products summed exactly and added to an
    f32 running sum from zero, rounded once a k-step (to nearest, or with
    ``truncate`` toward zero)."""
    a, b = tf32_round(a).double(), tf32_round(b).double()
    m, kk = a.shape
    pad = -kk % k
    a = torch.nn.functional.pad(a, (0, pad)).reshape(m, -1, k)
    b = torch.nn.functional.pad(b, (0, 0, 0, pad)).reshape(-1, k, b.shape[1])
    acc = torch.zeros((m, b.shape[2]), dtype=torch.float32)
    for s in torch.einsum("mgk,gkn->gmn", a, b):
        acc = round_f32(acc.double() + s, truncate)
    return acc


def tiled(mm):
    """h1ᵀ·dp2 as B2w sums it: ``mm`` over each tile of 128 paths (the
    contraction), the tiles' sums added in f32 in order."""
    def product(a, b):
        acc = None
        for p0 in range(0, a.shape[1], TILE):
            part = mm(a[:, p0:p0 + TILE], b[p0:p0 + TILE])
            acc = part if acc is None else acc + part
        return acc
    return product


def mm_plain_tf32(a, b):
    """a @ b on operands rounded to TF32, summed by one f32 matmul: the
    plain version's product, and B1w's."""
    return torch.matmul(tf32_round(a), tf32_round(b))


def kernels(forward, truncate: bool):
    """(B1's h1·W2, B2's recomputed h1·W2, dp2·W2ᵀ and h1ᵀ·dp2): the
    forward's product ``forward``, B2's three in one TF32 pass by k-steps
    of 8 (to nearest or truncated)."""
    tc = functools.partial(mm_steps, truncate=truncate)
    return (forward, tc, tc, tiled(tc))


def first_layer_tf32(w1, b1, t, x, j):
    """h1 of the TF32 mode: t·W1[t] + x·W1[x] + J·W1[J] + b1 term by term,
    as ``gamma_head(..., head_tf32=True)`` and the kernels sum it."""
    return torch.tanh(t[:, None] * w1[0] + x[:, None] * w1[1]
                      + j[:, None] * w1[2] + b1)


def emulated_gamma(mms, gam):
    (w1, w2, w3), (b1, b2, b3) = gam["W"], gam["b"]

    def gamma(i, x, ji):
        h1 = first_layer_tf32(w1, b1, torch.full_like(x, float(i)), x, ji)
        return (KernelHead.apply(h1, w2, b2, w3, mms) + b3)[..., 0]
    return gamma


def st_tf32(x):
    """float64 ``x`` with the value of its TF32 rounding (through f32) and
    the gradient of the identity."""
    return x + (tf32_round(x.float()).double() - x).detach()


class Tf32Matmul64(torch.autograd.Function):
    """a @ b in float64 on TF32 operands, the cotangent rounded to TF32
    before each product of the backward: ``ops/numerics.tf32_matmul`` with
    exact sums."""

    @staticmethod
    def forward(ctx, a, b):
        ar, br = st_tf32(a).detach(), st_tf32(b).detach()
        ctx.save_for_backward(ar, br)
        return ar @ br

    @staticmethod
    def backward(ctx, g):
        ar, br = ctx.saved_tensors
        gr = st_tf32(g).detach()
        return gr @ br.T, ar.T @ gr


def float64_gamma(gam):
    (w1, w2, w3), (b1, b2, b3) = gam["W"], gam["b"]

    def gamma(i, x, ji):
        h1 = first_layer_tf32(w1, b1, torch.full_like(x, float(i)), x, ji)
        h2 = torch.tanh(Tf32Matmul64.apply(h1, w2) + b2)
        return (h2 @ w3 + b3)[..., 0]
    return gamma


def masked_grads(model, leaves, run, keep):
    xn, yn = run
    loss = torch.sum(keep.to(xn.dtype) * torch.square(
        yn - model.payoff(xn))) / BATCH
    return loss, torch.autograd.grad(loss, leaves)


def distances(mms, h: int):
    """{reference: (loss's relative distance, each leaf's, the global
    norm's)} of the emulated kernels from the TF32 plain version ("plain")
    and from its float64 evaluation ("float64"), each over the paths that
    straddle nothing between the two, and the most paths set aside."""
    model, gam, y0, tables, dw, j = case(h)
    out, skipped = {}, 0
    for ref in ("plain", "float64"):
        leaves, g, y, tabs = _leaves(gam, y0, tables, torch.float32)
        k = rollout_plain(model, g, y, tabs, dw, j, residuals=True,
                          gamma=emulated_gamma(mms, g))
        if ref == "plain":
            rl, rg, ry, rt = _leaves(gam, y0, tables, torch.float32)
            p = rollout_plain(model, rg, ry, rt, dw, j, residuals=True,
                              head_tf32=True)
        else:
            rl, rg, ry, rt = _leaves(gam, y0, tables, torch.float64)
            p = rollout_plain(_float64_model(model), rg, ry, rt, dw.double(),
                              j.double(), residuals=True,
                              gamma=float64_gamma(rg))
        skip = straddling(model, tables, (k[0], k[2], k[3]),
                          (p[0], p[2], p[3]))
        skipped = max(skipped, int(skip.sum()))
        lk, gk = masked_grads(model, leaves, k[:2], ~skip)
        lp, gp = masked_grads(model, rl, p[:2], ~skip)
        loss_rel = abs(float(lk.detach()) - float(lp.detach())) / abs(
            float(lp.detach()))
        leaf = {n: float((a.double() - b.double()).norm() / b.double().norm())
                for n, a, b in zip(LEAVES, gk, gp)}
        num = math.sqrt(sum(float(((a.double() - b.double()) ** 2).sum())
                            for a, b in zip(gk, gp)))
        den = math.sqrt(sum(float((b.double() ** 2).sum()) for b in gp))
        out[ref] = (loss_rel, leaf, num / den)
    return out, skipped


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_k_steps_round_once_each():
    """``mm_steps`` on TF32 operands: within K/8 f32 roundings of the exact
    product, and zero padding exact; a truncated rounding never above the
    value in magnitude, and within an f32 unit of it."""
    gen = torch.Generator().manual_seed(0)
    a = torch.randn(16, 20, generator=gen)
    b = torch.randn(20, 24, generator=gen)
    ar, br = tf32_round(a).double(), tf32_round(b).double()
    exact = ar @ br
    got = mm_steps(a, b)
    bound = 3 * 2.0 ** -24 * (ar.abs() @ br.abs())
    assert bool(((got.double() - exact).abs() <= bound).all())
    v = exact.flatten() * (1.0 + 2.0 ** -30)
    cut = round_f32(v, truncate=True).double()
    assert bool((cut.abs() <= v.abs()).all())
    assert bool(((v - cut).abs() < 2.0 ** -23 * v.abs()).all())
    padded = mm_steps(torch.nn.functional.pad(a, (0, 12)),
                      torch.nn.functional.pad(b, (0, 0, 0, 12)))
    assert torch.equal(got, padded)


@pytest.mark.parametrize("h,truncate", [(20, False), (20, True),
                                        (64, True), (128, True)])
def test_the_tf32_pair_holds_the_chip_tolerances(h, truncate):
    """B1w TF in the plain order and B2w TF with its three products in one
    TF32 pass (k-steps rounded to nearest or truncated): within the chip's
    tolerances of the TF32 plain version and of its float64 evaluation."""
    dist, skipped = distances(kernels(mm_plain_tf32, truncate), h)
    assert skipped < 0.01 * BATCH, skipped
    for ref, (loss_rel, leaf, rel) in dist.items():
        assert loss_rel <= LOSS_TOL, (ref, loss_rel)
        assert rel <= GRAD_TOL, (ref, rel)
        assert max(leaf.values()) <= GRAD_TOL, (ref, leaf)


def test_a_truncating_forward_misses_at_20():
    """Why B1w TF keeps the plain order: with h1·W2 summed in another order
    that rounds to nearest (k-steps of 8) the gradient stays within the
    tolerance of the TF32 plain version at hidden 20; summed so that every
    term truncates (k-steps of 1), every path's Z shifts toward zero and
    the gradient misses it, as the card's tensor-core forward did."""
    near = distances(kernels(mm_steps, False), 20)[0]["plain"]
    cut = distances(kernels(functools.partial(mm_steps, k=1, truncate=True),
                            True), 20)[0]["plain"]
    assert near[2] <= GRAD_TOL and max(near[1].values()) <= GRAD_TOL, near
    assert cut[2] > GRAD_TOL or max(cut[1].values()) > GRAD_TOL, cut


@pytest.mark.parametrize("h,cap", [(20, 396), (64, 264), (128, 132)])
def test_tf32_b2w_blocks_fill_the_card(h, cap):
    """The head-TF32 B2w's blocks at batch 2^17: as many as an H100 holds
    at once, three an SM at HP 32 where the split instance holds two
    (``csrc/rollout_wide_bwd.cu`` ``bwd_blocks_per_sm``), and its partial
    buffer sized by them."""
    assert R.b2_wide_blocks(2**17, h, tf32=True) == min(2**17 // 128, cap)
    assert R.b2_partial_shape(50, 2**17, h, 8, tf32=True)[0] == min(
        2**17 // 128, cap)
    assert R.b2_wide_blocks(2**17, h) == min(2**17 // 128,
                                            132 if h > 64 else 264)
