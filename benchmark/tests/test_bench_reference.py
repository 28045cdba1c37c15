"""The plain reference against the port's plain (CPU) versions at tiny
sizes: tables, quadratures, prices, the noise drawn from one generator
state, the hoisted tables, and one step's loss and gradients."""

import dataclasses

import pytest
import torch

from benchmark import harness
from benchmark.reference import models as rm
from benchmark.reference import training as rt

CELLS = ["merton.fused_speed", "merton.parity", "vg.parity"]


def _pair(cell, batch=96):
    wl, cfg = harness.load_cell(cell)
    model, solver = harness.build_program(cfg, wl, "cpu")
    scheme = rt.Scheme(cfg, wl.get("model", {}), wl["solver"], batch, "cpu",
                       block=40)
    return wl, cfg, model, solver, scheme


@pytest.mark.parametrize("cell", CELLS)
def test_noise_redrawn_from_the_generator_state(cell):
    _, _, _, solver, scheme = _pair(cell)
    g = torch.Generator().manual_seed(11)
    state = g.get_state()
    dw, j = solver._prenoise(g, 96)[:2]
    g.set_state(state)
    rdw, rj = scheme.model.draw(g, 96)
    assert torch.equal(dw, rdw) and torch.equal(j, rj)


@pytest.mark.parametrize("cell", ["merton.parity", "vg.parity"])
def test_quadrature_and_price(cell):
    wl, cfg, model, solver, scheme = _pair(cell)
    nodes, weights = solver._quad
    assert torch.equal(nodes, scheme.nodes)
    assert torch.equal(weights, scheme.weights)
    x = torch.linspace(0.5, 1.8, 101)
    for i in (0, 7, int(cfg["N"]) - 1):
        assert torch.allclose(model.price(i, x), scheme.model.price(i, x),
                              rtol=1e-6, atol=1e-7)


def test_vg_fft_curves_equal_the_program_tables():
    _, _, model, _, scheme = _pair("vg.parity")
    assert torch.equal(model.tables("cpu")["fft"], scheme.model.curve)
    assert scheme.model.grid == pytest.approx(model._grid)


def test_mul_exp_matches():
    from deepfbsdejsolvers_torch.ops.numerics import mul_exp

    x = torch.rand(1000) + 0.5
    u = torch.randn(1000) * 0.3
    assert torch.equal(mul_exp(x, u), rm.mul_exp(x, u))


def test_hoisted_tables_match():
    wl, cfg, model, solver, scheme = _pair("merton.fused_speed")
    params = harness.make_params(cfg, True, 5, "cpu")
    g = torch.Generator().manual_seed(3)
    noise = solver._prenoise(g, 96)
    prog = solver._hoist_tables(params, noise)
    mine = scheme.tables(params, *noise)
    for k in ("lo", "hi", "cc", "pc", "zc"):
        assert torch.allclose(prog[k], mine[k], rtol=1e-5, atol=1e-6), k


@pytest.mark.parametrize("cell", CELLS)
def test_one_step_loss_and_gradients(cell):
    wl, cfg, model, solver, scheme = _pair(cell)
    params = harness.make_params(cfg, solver.jump_diff, 9, "cpu")
    from deepfbsdejsolvers_torch.nets.mlp import param_leaves

    for t in param_leaves(params):
        t.requires_grad_(True)
    g = torch.Generator().manual_seed(21)
    noise = solver._prenoise(g, 96)
    loss = solver.build_loss_from_noise(96)(params, noise)
    grads = torch.autograd.grad(loss, param_leaves(params))
    r_loss, r_grads = scheme.loss_and_grads(params, *noise[:2])
    assert r_loss == pytest.approx(float(loss.detach()), rel=1e-5)
    # the Γ head's leaves are differences of Γ and its compensator that
    # cancel: at 96 paths the program's f32 sits up to 5e-3 of such a leaf
    # from float64 (the reference sums them in float64), so a leaf is held
    # against the median leaf's norm where that is larger
    norms = sorted(float(v.norm()) for v in r_grads.values())
    median = norms[len(norms) // 2]
    for (name, _), gp in zip(rt.leaves(params), grads):
        gr = r_grads[name]
        scale = max(float(gr.norm()), median)
        assert float((gp - gr).norm()) <= 2e-3 * scale, name


def test_adam_matches_torch():
    p = torch.randn(7, 3, requires_grad=True)
    q = p.detach().clone()
    opt = torch.optim.Adam([p], lr=4e-4, eps=1e-7)
    state = {}
    for k in range(3):
        g = torch.randn(7, 3)
        p.grad = g.clone()
        opt.step()
        rt.adam_update({"h": {"W": [q]}}, {"h.W0": g}, state, 4e-4,
                       (0.9, 0.999), 1e-7)
    assert torch.allclose(p.detach(), q, rtol=0, atol=1e-7)


def test_tf32_rounding_keeps_ten_bits():
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -12, 3.0])
    assert rt.tf32(x).tolist() == [1.0 + 2 ** -10, 1.0 + 2 ** -10, 3.0]
