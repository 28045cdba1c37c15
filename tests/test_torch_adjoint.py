"""The hand-written adjoint (``solvers/adjoint.py``, ``adjoint=True``)
against the JAX package's ``make_global_adjoint_rollout`` and against the
port's own autograd, at shared params and noise (hidden (8, 8), the speed
configuration's hoisted piecewise tables): the loss within 1e-6 and the
gradients within 3e-5 relative, tests/test_adjoint.py's tolerances.  Its
scope is the JAX package's ``_adjoint_ok``; outside it the CPU warns and
falls back to autograd, the card raises."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from deepfbsdejsolvers_torch.models.merton import (
    make_merton_default as torch_merton)
from deepfbsdejsolvers_torch.nets.mlp import param_leaves
from deepfbsdejsolvers_torch.ops.compensator import CompensatorSpec
from deepfbsdejsolvers_torch.solvers.adjoint import (
    make_global_adjoint_rollout)
from deepfbsdejsolvers_torch.solvers.pricing import PricingSolver
from test_torch_pricing import port_params, rel_norm
from test_torch_schemes import jax_noise, make_pair

HOIST = dict(hoist=True, hoist_interp="piecewise")
COMP = dict(x_interp="chebyshev", n_cheb=16)
SPEED_MODEL = dict(jump_sampler="icdf", price_mode="chebyshev")


def _jax_loss_and_grads(js, jparams, key, batch):
    with jax.default_matmul_precision("highest"):
        lj, gj = jax.jit(jax.value_and_grad(js.build_loss(batch)))(jparams,
                                                                   key)
    return float(lj), [np.asarray(g) for g in jax.tree_util.tree_leaves(gj)]


def _port_loss_and_grads(ts, p, noise, batch):
    loss = ts.build_loss_from_noise(batch)(p, noise)
    return float(loss.detach()), [g.numpy() for g in torch.autograd.grad(
        loss, param_leaves(p))]


@pytest.mark.parametrize("a_lin", [0.0, 0.1])
def test_adjoint_matches_jax_adjoint(a_lin):
    js, ts, jparams = make_pair("global", a_lin=a_lin, comp=COMP,
                                model=SPEED_MODEL, adjoint=True, **HOIST)
    assert ts._adjoint
    key, batch = jax.random.key(11), 512
    lj, gj = _jax_loss_and_grads(js, jparams, key, batch)
    lt, gt = _port_loss_and_grads(ts, port_params(jparams),
                                  jax_noise(js, key, batch), batch)
    assert lt == pytest.approx(lj, rel=1e-6)
    assert rel_norm(gt, gj) < 3e-5


@pytest.mark.parametrize("a_lin", [0.0, 0.1])
def test_adjoint_matches_autograd(a_lin):
    """The same loss as the autograd path (its forward runs the solver's
    hoisted step in the same order), every gradient within 3e-5, and every
    head and table receiving gradient."""
    model = dataclasses.replace(torch_merton(a_lin=a_lin, **SPEED_MODEL),
                                N=5)
    auto = PricingSolver(model, "global", hidden=(8, 8), device="cpu",
                         compensator=CompensatorSpec(**COMP), **HOIST)
    adj = dataclasses.replace(auto, adjoint=True)
    p = auto.init_params(torch.Generator().manual_seed(0))
    for t in param_leaves(p):
        t.requires_grad_(True)
    noise = auto._prenoise(torch.Generator().manual_seed(1), 256)
    la, ga = _port_loss_and_grads(auto, p, noise, 256)
    lj, gj = _port_loss_and_grads(adj, p, noise, 256)
    assert lj == pytest.approx(la, rel=1e-6)
    assert rel_norm(gj, ga) < 3e-5
    for name in ("gam", "uz"):
        n = sum(float(np.abs(g).sum()) for g, t in zip(gj, param_leaves(p))
                if any(t is u for u in param_leaves(p[name])))
        assert np.isfinite(n) and n > 0, name


def test_adjoint_table_cotangents_match_autograd():
    """The rollout alone: the cotangents of y0, the head and the three
    tables equal autograd's of the same forward."""
    model = dataclasses.replace(torch_merton(**SPEED_MODEL), N=4)
    solver = PricingSolver(model, "global", hidden=(8, 8), device="cpu",
                           compensator=CompensatorSpec(**COMP), **HOIST)
    p = solver.init_params(torch.Generator().manual_seed(0))
    dw, j = solver._prenoise(torch.Generator().manual_seed(2), 128)
    with torch.no_grad():
        tables = solver._hoist_tables(p, (dw, j))
    leaf = lambda t: t.detach().clone().requires_grad_(True)
    gam = {k: [leaf(t) for t in v] for k, v in p["gam"].items()}
    y0 = leaf(p["uz"]["y0"])
    tabs = {k: leaf(v) if k in ("cc", "pc", "zc") else v
            for k, v in tables.items()}
    leaves = [*gam["W"], *gam["b"], y0, tabs["cc"], tabs["pc"], tabs["zc"]]
    apply_gam = lambda gp, i, x, jj: solver._apply(
        gp, solver._gamma_inputs(i, x, jj))[..., 0]
    roll = make_global_adjoint_rollout(model, apply_gam)

    def loss(x, y):
        return torch.mean(torch.square(y - model.payoff(x)))

    g_adj = torch.autograd.grad(loss(*roll(gam, y0, tabs, dw, j)), leaves)
    x, y, _, _ = roll.forward(gam, y0, tabs["cc"], tabs["pc"], tabs["zc"],
                              tabs["lo"], tabs["hi"], dw, j)
    g_auto = torch.autograd.grad(loss(x, y), leaves)
    for a, b in zip(g_adj, g_auto):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-5,
                                   atol=2e-6 * float(b.abs().max()))


@pytest.mark.parametrize("kw", [
    dict(scheme="multistep1", **HOIST), dict(scheme="global"),
    dict(scheme="global", hoist_z=False, **HOIST),
    dict(scheme="global", hoist=True),
])
def test_adjoint_scope_falls_back_on_the_cpu_and_raises_on_the_card(kw):
    """Outside the JAX package's ``_adjoint_ok`` (the global
    jump-diffusion scheme on hoisted piecewise tables with Z and price
    tables): a warning and autograd on the CPU, ValueError on the card."""
    model = dataclasses.replace(torch_merton(**SPEED_MODEL), N=3)
    args = dict(kw, hidden=(8, 8), adjoint=True,
                compensator=CompensatorSpec(**COMP))
    with pytest.warns(UserWarning, match="falling back to autodiff"):
        s = PricingSolver(model, device="cpu", **args)
    assert not s._adjoint
    with pytest.raises(ValueError, match="adjoint=True precondition"):
        PricingSolver(model, device="cuda", **args)


def test_fused_rollout_takes_precedence_over_the_adjoint():
    """As in the JAX package, ``fused_rollout`` is checked first."""
    model = dataclasses.replace(torch_merton(**SPEED_MODEL), N=3)
    s = PricingSolver(model, "global", hidden=(8, 8), device="cpu",
                      adjoint=True, fused_rollout=True,
                      compensator=CompensatorSpec(**COMP), **HOIST)
    assert not s._adjoint
