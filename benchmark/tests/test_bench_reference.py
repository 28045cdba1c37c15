"""The plain reference against the port's plain (CPU) versions at tiny
sizes: tables, quadratures, prices, the noise drawn from one generator
state (a Monte-Carlo compensator's draws too), the hoisted tables, one
step's loss and gradients, and the Monte-Carlo compensator against
float64; and the quadrature cells' reference steps, bit for bit as they
were recorded before the reference took Monte-Carlo draws."""

import pytest
import torch

from benchmark import harness
from benchmark.reference import models as rm
from benchmark.reference import training as rt

QUADRATURE_CELLS = ["merton.fused_speed", "merton.parity", "vg.parity"]
MC_CELL = "merton.parity_mc"
CELLS = QUADRATURE_CELLS + [MC_CELL]


def _pair(cell, batch=96):
    wl, cfg = harness.load_cell(cell)
    model, solver = harness.build_program(cfg, wl, "cpu")
    scheme = rt.Scheme(cfg, wl.get("model", {}), wl["solver"], batch, "cpu",
                       block=40)
    return wl, cfg, model, solver, scheme


@pytest.mark.parametrize("cell", QUADRATURE_CELLS)
def test_noise_redrawn_from_the_generator_state(cell):
    _, _, _, solver, scheme = _pair(cell)
    g = torch.Generator().manual_seed(11)
    state = g.get_state()
    dw, j = solver._prenoise(g, 96)[:2]
    g.set_state(state)
    rdw, rj = scheme.model.draw(g, 96)
    assert torch.equal(dw, rdw) and torch.equal(j, rj)


@pytest.mark.parametrize("cell", CELLS)
def test_a_step_noise_redrawn_whole(cell):
    # dW, J and, with a Monte-Carlo compensator, the (N, n_mc) draws after
    # them, bit for bit; then the generator stands where the program's does
    _, cfg, _, solver, scheme = _pair(cell)
    g = torch.Generator().manual_seed(2 ** 31 + 11)
    state = g.get_state()
    noise = solver._prenoise(g, 96)
    after = torch.rand(4, generator=g)
    g.set_state(state)
    mine = scheme.draw(g)
    assert len(mine) == len(noise) == (3 if cell == MC_CELL else 2)
    assert all(torch.equal(a, b) for a, b in zip(noise, mine))
    assert torch.equal(torch.rand(4, generator=g), after)
    if cell == MC_CELL:
        assert tuple(mine[2].shape) == (int(cfg["N"]), 5000)
        assert scheme.n_nodes == 5000


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


# The loss's relative tolerance: 1e-5, but 1e-3 on the Monte-Carlo cell,
# where the program's plain (CPU) version of B3 sums a path's 5000 × 21
# products in float32 without compensation (the kernel on the card
# compensates): its compensator sits ~7e-5 from float64, its loss 2e-4 at
# 96 paths, where the reference's sits 5e-8 (test_mc_reference_near_float64)
LOSS_REL = {MC_CELL: 1e-3}


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
    r_loss, r_grads = scheme.loss_and_grads(params, *noise)
    assert r_loss == pytest.approx(float(loss.detach()),
                                   rel=LOSS_REL.get(cell, 1e-5))
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


def _leaves(params, dtype=torch.float32):
    """A copy of ``params`` in ``dtype`` whose leaves require grad."""
    return {h: {k: ([t.detach().to(dtype).requires_grad_(True) for t in v]
                    if isinstance(v, list)
                    else v.detach().to(dtype).requires_grad_(True))
                for k, v in p.items()} for h, p in params.items()}


def test_mc_compensator_is_the_plain_mean(monkeypatch):
    _, cfg, _, solver, whole = _pair(MC_CELL)
    assert whole.node_block >= 5000
    # 700 draws a block of 40 paths: 8 blocks, the last of 100
    monkeypatch.setattr(rt, "NODE_ROWS", 700 * 40)
    scheme = _pair(MC_CELL)[4]
    assert scheme.node_block == 700
    params = harness.make_params(cfg, True, 9, "cpu")
    draws = solver._prenoise(torch.Generator().manual_seed(5), 96)[2][3]
    x = torch.linspace(0.5, 1.8, 96)
    with torch.no_grad():
        got = scheme.mc_compensator(params, 3, x, draws)
        want = scheme.gamma(_leaves(params, torch.float64), 3,
                            x.double()[None, :],
                            draws.double()[:, None]).mean(0)
        one_block = whole.mc_compensator(params, 3, x, draws)
    assert float(((got.double() - want) / want).abs().max()) < 1e-6
    # blocks change nothing but the order of a float64 sum
    assert torch.allclose(got, one_block, rtol=1e-7, atol=0)


def test_mc_reference_near_float64():
    # the reference's step in FP32 against the same step in float64: the
    # loss within 1e-6 and every leaf but the Γ output bias within 1e-4
    # (Γ and its compensator carry that bias whole, so its gradient is
    # rounding alone)
    _, cfg, _, solver, scheme = _pair(MC_CELL)
    params = harness.make_params(cfg, True, 9, "cpu")
    noise = solver._prenoise(torch.Generator().manual_seed(21), 96)
    loss, grads = scheme.loss_and_grads(_leaves(params), *noise)
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        loss64, grads64 = scheme.loss_and_grads(
            _leaves(params, torch.float64), *(t.double() for t in noise))
    finally:
        torch.set_default_dtype(old)
    assert abs(loss - loss64) <= 1e-6 * loss64
    for name, g64 in grads64.items():
        if name == "gam.b2":
            continue
        gap = float((grads[name].double() - g64).norm() / g64.norm())
        assert gap < 1e-4, name


# The quadrature cells' reference: two steps from fixed weights and a fixed
# generator state at 96 paths in blocks of 40, the losses and each leaf's
# first gradient norm as float.hex, recorded from the reference as it was
# before it took Monte-Carlo draws.  Bit for bit: the quadrature path's
# arithmetic did not change.
RECORDED = {
    "merton.fused_speed": [
        "0x1.53db6a6000000p+1", "0x1.705cc68000000p+1",
        "0x1.a3b2aeaf80a0cp-3", "0x1.93fd01550f172p-3",
        "0x1.b746b17bc9e54p-4", "0x1.ffff45691098ap-6",
        "0x1.cdae0524caf1cp-6", "0x1.c000000000000p-18",
        "0x1.10630977c56c4p+4", "0x1.8a52c4c6fb773p+3",
        "0x1.8a632e0d7ebd8p+2", "0x1.71593db9e89f8p-1",
        "0x1.7ee98b6ae3967p+1", "0x1.1baeb00000000p+1",
        "0x1.5bd8fe0000000p+1"],
    "merton.parity": [
        "0x1.6800d1c000000p+1", "0x1.64f8564000000p+1",
        "0x1.e177eab849d1fp-2", "0x1.0b48d60b0f64cp-2",
        "0x1.2a3b919c2db60p-3", "0x1.8f44f51264bb1p-6",
        "0x1.3ec927aa7e1efp-5", "0x1.8000000000000p-22",
        "0x1.110d256688e31p+4", "0x1.7df3e96a7a08ap+3",
        "0x1.83583f51ea577p+2", "0x1.61aedfb3a7180p-1",
        "0x1.73595c9694498p+1", "0x1.169d280000000p+1",
        "0x1.7919780000000p+1"],
    "vg.parity": [
        "0x1.74c6f68000000p+1", "0x1.7f6478c000000p+1",
        "0x1.0b0fbeb7cc44cp-4", "0x1.daa0eec236c04p-5",
        "0x1.bf375a8191528p-5", "0x1.25c91de5cb975p-7",
        "0x1.7245f5f8f303ap-8", "0x1.1000000000000p-20",
        "0x1.050a7e0000000p+2"],
}


@pytest.mark.parametrize("cell", QUADRATURE_CELLS)
def test_quadrature_reference_steps_as_recorded(cell):
    wl, cfg = harness.load_cell(cell)
    params = harness.make_params(cfg, cfg["model"] == "merton", 7, "cpu")
    g = torch.Generator().manual_seed(2 ** 31 + 5)
    scheme = rt.Scheme(cfg, wl.get("model", {}), wl["solver"], 96, "cpu",
                       block=40)
    losses, grads, _ = rt.follow(scheme, params, g.get_state(), 2, cfg)
    got = [float(v).hex() for v in losses] + [
        float(rt.norm(grads[n])).hex() for n in sorted(grads)]
    assert got == RECORDED[cell]
