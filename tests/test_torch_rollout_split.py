"""The split-TF32 arithmetic of the wide rollout kernels, emulated on the CPU.

The wide B2 (``csrc/rollout_wide_bwd.cu``) runs the Γ head's three H×H
products on the tensor cores in split TF32, as the wide sweep pair does
(``tests/test_torch_sweep_split.py``, whose TF32 emulation this file
shares): each f32 operand is split into hi = tf32(a) and lo = a − hi, read
as TF32, and a·b is formed as hi·hi + (hi·lo + lo·hi): it recomputes the
second layer h1·W2 from B1's residuals and forms dp2·W2ᵀ and the sum over
paths h1ᵀ·dp2.  The wide B1 (``csrc/rollout_wide_fwd.cu``) sums its one
product, h1·W2, in f32 in the plain version's order.  Here the hoisted
Merton rollout of ``ops/rollout.py`` (``rollout_plain``'s steps) runs in
f32 with the Γ head's second layer and output (``KernelHead``) taken that
way, each product one matmul of the rounded parts, the rest in f32, and
its loss and gradients are held to a float64 evaluation of
``rollout_plain`` within the tolerances ``chip_smoke.py`` holds the
kernels to on the card: the loss to 1e-5 relative, each gradient leaf
(W1, W2, W3, b1, b2, b3, y0 and the three tables) and their global norm to
1e-4 relative.  One TF32 pass (tf32(a)·tf32(b)) misses them.

Why B1 keeps its product in f32: it sets every path's trajectory, and the
loss's gradient, a sum over paths of (y_N − g(x_N)) times the path's
sensitivities that largely cancels, magnifies an error that the paths
share.  W2's two-term split is such an error: with it in the forward the
emulation misses at hidden 20.  On the card a forward with W2 in three
terms, and one on the FP64 tensor cores, missed the 1e-4 check against
the plain version at hidden 20 too: the plain version's own f32 rounding
drifts from float64 in a way the paths share, and only its own summation
order reproduces that drift.  B2's products enter only the paths'
sensitivities.

A path whose f32 and float64 trajectories lie on two sides of a
discontinuity of the gradient (a piece of the tables, the sign in the
coupling |y − A|, the payoff's kink) carries its whole gradient into
another branch; as in ``chip_smoke.py``'s ``check_wide_grads``, such paths
get no weight in either loss, and they must be fewer than 1%.

The inputs are the speed configuration's (``fused_rollout=True``): N = 50
steps, 1024 paths, a Γ head of seeded weights with non-zero biases at
hidden 20, 64 and 128, the hoisted piecewise tables of its own noise."""

import dataclasses
import functools
import math

import numpy as np
import pytest
import torch

from deepfbsdejsolvers_torch.models.merton import make_merton_default
from deepfbsdejsolvers_torch.ops.compensator import CompensatorSpec
from deepfbsdejsolvers_torch.ops.rollout import rollout_plain, table_eval
from deepfbsdejsolvers_torch.solvers.pricing import PricingSolver
from deepfbsdejsolvers_torch.solvers.train import make_generator
from test_torch_sweep_split import mm_one, mm_split

N, BATCH = 50, 1024
LOSS_TOL, GRAD_TOL = 1e-5, 1e-4
LEAVES = ("W1", "W2", "W3", "b1", "b2", "b3", "y0", "cc", "pc", "zc")


# (B1's h1·W2, B2's recomputed h1·W2, dp2·W2ᵀ and h1ᵀ·dp2): the kernels'
# products, one TF32 pass, and the forward in split TF32 too
KERNELS = (torch.matmul, mm_split, mm_split, mm_split)
ONE_PASS = (mm_one,) * 4
SPLIT_FORWARD = (mm_split,) * 4
EXACT = (torch.matmul,) * 4


class KernelHead(torch.autograd.Function):
    """h1 ↦ tanh(h1·W2 + b2)·W3 with the products of ``mms``: the forward
    by mms[0]; the backward recomputes the second layer by mms[1] (as B2
    does from B1's residuals) and takes dp2·W2ᵀ by mms[2] and h1ᵀ·dp2 by
    mms[3]."""

    @staticmethod
    def forward(ctx, h1, w2, b2, w3, mms):
        ctx.save_for_backward(h1, w2, b2, w3)
        ctx.mms = mms
        return torch.matmul(torch.tanh(mms[0](h1, w2) + b2), w3)

    @staticmethod
    def backward(ctx, g):
        h1, w2, b2, w3 = ctx.saved_tensors
        mms = ctx.mms
        h2 = torch.tanh(mms[1](h1, w2) + b2)
        dp2 = (torch.matmul(g, w3.T) * (1.0 - h2 * h2)).contiguous()
        return (mms[2](dp2, w2.T.contiguous()),
                mms[3](h1.T.contiguous(), dp2), dp2.sum(0),
                torch.matmul(h2.T, g), None)


def rollout_emulated(mms, model, gam, y0, tables, dw, j):
    """(x_N, y_N, xs, ys) of ``rollout_plain``'s steps in f32 with the Γ
    head's products by ``mms`` (``KernelHead``)."""
    (w1, w2, w3), (b1, b2, b3) = gam["W"], gam["b"]
    n, batch = j.shape
    x = model.init_x(batch, j.device)
    y = y0 * torch.ones((batch,), dtype=torch.float32)
    xs, ys = [], []
    for i in range(n):
        xs.append(x)
        lo, hi = tables["lo"][i], tables["hi"][i]
        t = torch.full_like(x, float(i))
        h1 = torch.tanh(torch.matmul(torch.stack([t, x, j[i]], -1), w1) + b1)
        g = (KernelHead.apply(h1, w2, b2, w3, mms) + b3)[..., 0]
        comp = table_eval(tables["cc"][i], x, lo, hi)
        y = y - model.dt * model.f(y) + g - comp
        price = table_eval(tables["pc"][i], x, lo, hi)
        y = y + table_eval(tables["zc"][i], x, lo, hi) * dw[i]
        ys.append(y)
        x = model.step(i, x, dw[i], j[i], y, price=price)
    return x, y, torch.stack(xs), torch.stack(ys)


@functools.lru_cache(maxsize=None)
def case(h: int):
    """(model, Γ head, y0, tables, dW, J) of the speed configuration at
    hidden ``h``, f32, detached."""
    model = dataclasses.replace(
        make_merton_default(jump_sampler="icdf", price_mode="chebyshev"), N=N)
    solver = PricingSolver(
        model, "global", hidden=(h, h),
        compensator=CompensatorSpec(x_interp="chebyshev", n_cheb=64),
        hoist=True, hoist_interp="piecewise", fused_rollout=True,
        device="cpu")
    params = solver.init_params(make_generator("cpu", 0, 0))
    gb = make_generator("cpu", 0, 2)
    with torch.no_grad():
        for b in params["gam"]["b"]:
            b.copy_(0.1 * torch.randn(b.shape, generator=gb))
        dw, j = solver._prenoise(make_generator("cpu", 0, 3), BATCH)
        tables = solver._hoist_tables(params, (dw, j))
    gam = {k: [t.detach().clone() for t in v] for k, v in
           params["gam"].items()}
    y0 = params["uz"]["y0"].detach().clone()
    return model, gam, y0, {k: v.detach() for k, v in tables.items()}, dw, j


def _leaves(gam, y0, tables, dtype):
    """Fresh leaves of (W1, W2, W3, b1, b2, b3, y0, cc, pc, zc) in
    ``dtype``, and the Γ head and tables built on them."""
    leaf = lambda t: t.to(dtype).clone().requires_grad_(True)
    g = {"W": [leaf(w) for w in gam["W"]], "b": [leaf(b) for b in gam["b"]]}
    tabs = {k: (leaf(v) if k in ("cc", "pc", "zc") else v.to(dtype))
            for k, v in tables.items()}
    y = leaf(y0)
    return [*g["W"], *g["b"], y, tabs["cc"], tabs["pc"], tabs["zc"]], g, y, \
        tabs


def _float64_model(model):
    """``model`` with its paths started in float64, so that
    ``rollout_plain`` runs in float64 on float64 inputs."""
    m = dataclasses.replace(model)
    x0 = model.x0
    object.__setattr__(m, "init_x", lambda batch, device="cpu": torch.full(
        (batch,), x0, dtype=torch.float64, device=device))
    return m


def straddling(model, tables, a, b):
    """The paths whose trajectories ``a`` and ``b`` (each (x_N, xs, ys))
    lie, at some step, on two sides of a discontinuity of the gradient or
    within a margin of one (as ``chip_smoke.py``'s ``straddling_paths``):
    the piece of the tables, the sign of y − A(x), x_N against K."""
    p = tables["cc"].shape[1]
    lo, hi = tables["lo"][:, None], tables["hi"][:, None]
    out = torch.zeros(a[0].shape, dtype=torch.bool)
    sides = []
    for xn, xs, ys in (a, b):
        xn, xs, ys = xn.double(), xs.double(), ys.double()
        s = torch.clamp((xs - lo) / torch.clamp(hi - lo, min=1e-6), 0, 1) * p
        k = torch.clamp(torch.floor(s), 0, p - 1)
        with torch.no_grad():
            price = torch.stack([table_eval(tables["pc"][i].double(), xs[i],
                                            tables["lo"][i], tables["hi"][i])
                                 for i in range(xs.shape[0])])
        u = ys - price
        out |= ((s - torch.round(s)).abs() < 1e-5).any(0)
        out |= (u.abs() < 4e-6).any(0) | ((xn - model.K).abs() < 1e-5)
        sides.append((k, torch.sign(u), xn > model.K))
    (k1, u1, g1), (k2, u2, g2) = sides
    return out | (k1 != k2).any(0) | (u1 != u2).any(0) | (g1 != g2)


def distances(mms, h: int):
    """(loss's relative distance, each leaf's, the global norm's, paths
    set aside) of the f32 rollout with its products by ``mms`` from the
    float64 rollout, over the paths that straddle nothing."""
    model, gam, y0, tables, dw, j = case(h)
    leaves, g, y, tabs = _leaves(gam, y0, tables, torch.float32)
    xk, yk, xsk, ysk = rollout_emulated(mms, model, g, y, tabs, dw, j)
    m64 = _float64_model(model)
    leaves64, g64, y64, tabs64 = _leaves(gam, y0, tables, torch.float64)
    xp, yp, xsp, ysp = rollout_plain(m64, g64, y64, tabs64, dw.double(),
                                     j.double(), residuals=True)
    skip = straddling(model, tables, (xk, xsk, ysk), (xp, xsp, ysp))
    keep = (~skip).double()
    loss = lambda x, yy: torch.sum(keep.to(x.dtype) * torch.square(
        yy - model.payoff(x))) / BATCH
    lk, l64 = loss(xk, yk), loss(xp, yp)
    gk = torch.autograd.grad(lk, leaves)
    gp = torch.autograd.grad(l64, leaves64)
    loss_rel = abs(float(lk.detach()) - float(l64.detach())) / abs(
        float(l64.detach()))
    leaf = {n: float((a.double() - b).norm() / b.norm())
            for n, a, b in zip(LEAVES, gk, gp)}
    num = math.sqrt(sum(float(((a.double() - b) ** 2).sum())
                        for a, b in zip(gk, gp)))
    den = math.sqrt(sum(float((b ** 2).sum()) for b in gp))
    return loss_rel, leaf, num / den, int(skip.sum())


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_exact_emulation_is_rollout_plain():
    """With exact f32 products the emulation is ``rollout_plain``: the
    forward bit for bit, the gradients to f32 rounding (the hand backward
    recomputes the second layer and sums in another order); only the
    products differ below."""
    model, gam, y0, tables, dw, j = case(20)
    leaves, g, y, tabs = _leaves(gam, y0, tables, torch.float32)
    a = rollout_emulated(EXACT, model, g, y, tabs, dw, j)
    b = rollout_plain(model, g, y, tabs, dw, j, residuals=True)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    ga = torch.autograd.grad(torch.mean(a[1] * a[0]), leaves)
    gb = torch.autograd.grad(torch.mean(b[1] * b[0]), leaves)
    for name, u, v in zip(LEAVES, ga, gb):
        assert float((u - v).norm() / v.norm()) < 1e-5, name


@pytest.mark.parametrize("h", [20, 64, 128])
def test_split_tf32_holds_the_chip_tolerances(h):
    loss_rel, leaf, rel, skipped = distances(KERNELS, h)
    assert skipped < 0.01 * BATCH, skipped
    assert loss_rel <= LOSS_TOL, loss_rel
    assert rel <= GRAD_TOL, rel
    assert max(leaf.values()) <= GRAD_TOL, leaf


@pytest.mark.parametrize("h", [20, 64, 128])
def test_one_tf32_pass_misses_them(h):
    loss_rel, leaf, rel, _ = distances(ONE_PASS, h)
    assert (loss_rel > LOSS_TOL or rel > GRAD_TOL
            or max(leaf.values()) > GRAD_TOL), (loss_rel, leaf)


def test_w2_in_two_terms_in_the_forward_misses_at_20():
    """Why B1 keeps its product in f32: with the forward's h1·W2 in split
    TF32 too, W2's split shifts every trajectory alike and moves the
    gradient past the chip's tolerance at hidden 20, where the loss's
    gradient cancels most."""
    loss_rel, leaf, rel, _ = distances(SPLIT_FORWARD, 20)
    assert rel > GRAD_TOL or max(leaf.values()) > GRAD_TOL, (rel, leaf)
