"""The fused rollout's precision knobs on the CPU.  ``fused_precision`` (the
JAX package's one-hot select dots) changes no bit of the port, whose
kernels and plain version select a piece by index.  ``fused_head_precision
="default"`` (one TF32 pass of the Γ head's H×H products) rounds each
operand of those products to TF32 in the plain version as the kernels do
(``csrc/rollout_common.cuh`` ``tf32_round``): held to a numpy reference of
the same rounding (the int32 view, half a unit of the 13 dropped bits added
and the bits cleared), products to 1e-6 relative (f32 sums of exact
products against float64 sums)."""

import dataclasses

import numpy as np
import pytest
import torch

from deepfbsdejsolvers_torch.models.merton import make_merton_default
from deepfbsdejsolvers_torch.nets.mlp import param_leaves
from deepfbsdejsolvers_torch.ops import rollout as R
from deepfbsdejsolvers_torch.ops.compensator import CompensatorSpec
from deepfbsdejsolvers_torch.ops.numerics import tf32_matmul, tf32_round
from deepfbsdejsolvers_torch.solvers.pricing import PricingSolver

HOIST = dict(compensator=CompensatorSpec(x_interp="chebyshev", n_cheb=16),
             hoist=True, hoist_interp="piecewise", fused_rollout=True)


def np_tf32(x):
    """Round float32 ``x`` to TF32: to nearest, ties away from zero."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def test_tf32_round_matches_numpy():
    rng = np.random.default_rng(0)
    x = np.concatenate([
        (rng.normal(size=5000) * 10.0 ** rng.integers(-20, 20, 5000)
         ).astype(np.float32),
        # exact ties of the 13 dropped bits, both signs, and zeros
        (np.array([1.0, 3.0, -5.0], np.float32).view(np.uint32)
         | np.uint32(0x1000)).view(np.float32),
        np.array([0.0, -0.0, 1.0, -1.0], np.float32)]).astype(np.float32)
    got = tf32_round(torch.tensor(x)).numpy()
    want = np_tf32(x)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    # ten mantissa bits kept, within half a unit of the eleventh
    assert np.all(got.view(np.uint32) & 0x1FFF == 0)
    assert np.all(np.abs(got - x) <= np.abs(x) * 2.0**-11)


def test_tf32_matmul_forward_and_backward_round_every_operand():
    rng = np.random.default_rng(1)
    a = rng.normal(size=(300, 21)).astype(np.float32)
    b = rng.normal(size=(21, 17)).astype(np.float32)
    g = rng.normal(size=(300, 17)).astype(np.float32)
    ta = torch.tensor(a, requires_grad=True)
    tb = torch.tensor(b, requires_grad=True)
    out = tf32_matmul(ta, tb)
    ga, gb = torch.autograd.grad(out, (ta, tb), torch.tensor(g))
    ar, br, gr = (np_tf32(v).astype(np.float64) for v in (a, b, g))
    for got, want in ((out.detach(), ar @ br), (ga, gr @ br.T),
                      (gb, ar.T @ gr)):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                   atol=1e-6 * np.abs(want).max())


def test_tf32_head_matches_numpy_reference():
    """``gamma_head(..., head_tf32=True)``: the first layer summed term by
    term in f32, h1 and W2 rounded, the product summed, then the f32 head;
    against the same in numpy, and a TF32 distance from the f32 head."""
    rng = np.random.default_rng(2)
    h = 21
    ws = [0.5 * rng.normal(size=s).astype(np.float32)
          for s in ((3, h), (h, h), (h, 1))]
    bs = [0.1 * rng.normal(size=s[1]).astype(np.float32)
          for s in ((3, h), (h, h), (h, 1))]
    cols = rng.normal(size=(500, 3)).astype(np.float32)
    params = {"W": [torch.tensor(w) for w in ws],
              "b": [torch.tensor(b) for b in bs]}
    got = R.gamma_head(params, torch.tensor(cols), head_tf32=True).numpy()
    c = cols[:, :, None]
    z1 = (c[:, 0] * ws[0][0] + c[:, 1] * ws[0][1]) + c[:, 2] * ws[0][2]
    h1 = np.tanh((z1 + bs[0]).astype(np.float32)).astype(np.float32)
    z2 = np_tf32(h1).astype(np.float64) @ np_tf32(ws[1]).astype(np.float64)
    h2 = np.tanh(z2 + bs[1])
    want = h2 @ ws[2] + bs[2]
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=2e-6)
    f32 = R.gamma_head(params, torch.tensor(cols)).numpy()
    assert 1e-5 < np.abs(got - f32).max() < 1e-2


def _fused(**kw):
    model = dataclasses.replace(make_merton_default(
        jump_sampler="icdf", price_mode="chebyshev"), N=4)
    return PricingSolver(model, "global", hidden=(8, 8), device="cpu",
                         **HOIST, **kw)


def _loss_and_grads(solver):
    p = solver.init_params(torch.Generator().manual_seed(0))
    for t in param_leaves(p):
        t.requires_grad_(True)
    loss = solver.build_loss(128)(p, torch.Generator().manual_seed(1))
    return loss.detach(), torch.autograd.grad(loss, param_leaves(p))


def test_fused_precision_changes_no_bit():
    """Both values of ``fused_precision`` (and None) give the same loss and
    gradients bit for bit: the piece select is by index."""
    base = _loss_and_grads(_fused())
    for value in ("default", "highest", "DEFAULT"):
        got = _loss_and_grads(_fused(fused_precision=value))
        assert torch.equal(got[0], base[0])
        assert all(torch.equal(a, b) for a, b in zip(got[1], base[1]))


def test_head_precision_runs_the_tf32_plain_version():
    """``fused_head_precision="default"`` reaches the operator (its plain
    version on the CPU, the head-TF32 instance on the card); "highest" and
    None are the f32 rollout bit for bit; another name raises."""
    op = _fused(fused_head_precision="default")._rollout()
    assert op.spec.head_tf32
    assert not _fused(fused_head_precision="highest")._rollout().spec.head_tf32
    f32 = _loss_and_grads(_fused())
    hi = _loss_and_grads(_fused(fused_head_precision="highest"))
    assert torch.equal(hi[0], f32[0])
    tf = _loss_and_grads(_fused(fused_head_precision="default"))
    assert 0 < abs(float(tf[0] - f32[0])) < 1e-2 * abs(float(f32[0]))
    for bad in ("high", "bf16"):
        with pytest.raises(ValueError, match="precision"):
            _fused(fused_head_precision=bad)
        with pytest.raises(ValueError, match="precision"):
            _fused(fused_precision=bad)


def test_rollout_plain_tf32_is_the_head_tf32_rollout():
    """``rollout_plain(head_tf32=True)``'s Γ equals ``gamma_head`` in its
    TF32 form step by step: the rollout with the TF32 head spliced in."""
    solver = _fused()
    p = solver.init_params(torch.Generator().manual_seed(0))
    dw, j = solver._prenoise(torch.Generator().manual_seed(3), 64)
    with torch.no_grad():
        tables = solver._hoist_tables(p, (dw, j))
        x, y = R.rollout_plain(solver.model, p["gam"], p["uz"]["y0"],
                               tables, dw, j, head_tf32=True)
        model = solver.model
        xr = model.init_x(64, "cpu")
        yr = p["uz"]["y0"] * torch.ones_like(xr)
        for i in range(model.N):
            lo, hi = tables["lo"][i], tables["hi"][i]
            t = torch.full_like(xr, float(i))
            gam = R.gamma_head(p["gam"], torch.stack([t, xr, j[i]], -1),
                               head_tf32=True)[..., 0]
            yr = (yr - model.dt * model.f(yr) + gam
                  - R.table_eval(tables["cc"][i], xr, lo, hi))
            price = R.table_eval(tables["pc"][i], xr, lo, hi)
            yr = yr + R.table_eval(tables["zc"][i], xr, lo, hi) * dw[i]
            xr = model.step(i, xr, dw[i], j[i], yr, price=price)
    assert torch.equal(x, xr) and torch.equal(y, yr)
