"""The rank-1 sweep on the pure-jump regime's two input forms, against the
JAX package: the Γ net's feature f = X·J, whose first-layer slope
a = W0[x] + J·W0[f] differs per node (``rank1_three_feature(x_prop=True)``),
and the one-output U-net's (t, X·(1 + J)) (``rank1_two_feature``, JAX's
``pack_two_feature``).  The vectors equal JAX's packed ones without the
lane packing; the sweep's values and gradients equal JAX's Pallas sweep,
run in interpret mode as on any machine without a TPU, over the 96-node
gamma-subordinated quadrature and 300 Monte-Carlo draws, at the tolerances
of tests/test_pallas_sweep.py (values rel 1e-4, gradients rel 1e-5).  The
heads, paths and draws come from a numpy seed."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepfbsdejsolvers_torch.models.variance_gamma import (
    make_vg_default as torch_vg)
from deepfbsdejsolvers_torch.ops import sweep as S
from deepfbsdejsolvers_torch.ops.compensator import CompensatorSpec
from deepfbsdejsolvers_torch.solvers.pricing import PricingSolver as TorchPS
from deepfbsdejsolvers_tpu.models.variance_gamma import (
    make_vg_default as jax_vg)
from deepfbsdejsolvers_tpu.ops import pallas_sweep as ps
from deepfbsdejsolvers_tpu.solvers.pricing import PricingSolver as JaxPS
from test_torch_pricing import rel_norm

STEP = 5
# the form's scheme: global sweeps its Γ net on X·J, sumlocal1 its U-net
SCHEME = {"x_prop": "global", "two_feature": "sumlocal1"}


@pytest.fixture(scope="module")
def quadrature():
    nodes, weights = torch_vg().jump_quadrature(CompensatorSpec())
    return nodes.numpy(), weights.numpy()


def head_params(n_in, h, rng):
    """A head [n_in] → h → h → 1 with non-zero biases, as numpy."""
    sizes = (n_in, h, h, 1)
    return {"W": [(rng.standard_normal((a, b)) / np.sqrt(a)).astype(
                np.float32) for a, b in zip(sizes[:-1], sizes[1:])],
            "b": [(0.1 * rng.standard_normal(b)).astype(np.float32)
                  for b in sizes[1:]]}


def inputs(form, h, node_set, batch, quadrature):
    """(head, x, nodes, weights) from a seeded numpy draw; the MC nodes are
    VG-like increments with uniform weights."""
    rng = np.random.default_rng(h * 1000 + batch)
    head = head_params(3 if form == "x_prop" else 2, h, rng)
    x = np.exp(0.2 * rng.standard_normal(batch)).astype(np.float32)
    if node_set == "quadrature":
        nodes, weights = quadrature
    else:
        nodes = (-0.003 + 0.04 * rng.standard_normal(300)).astype(np.float32)
        weights = np.full(300, 1.0 / 300, np.float32)
    return head, x, nodes, weights


def port_sweep(form, head, x, nodes, weights):
    """The port's E_J[Γ] (B,) in rank-1 form and the gradients of Σ
    sin(comp) w.r.t. the head and x (the probe of
    tests/test_pallas_sweep.py)."""
    leaves = [torch.tensor(t, requires_grad=True)
              for t in (*head["W"], *head["b"], x)]
    net = {"W": leaves[:3], "b": leaves[3:6]}
    t, n, w = torch.tensor(float(STEP)), torch.tensor(nodes), \
        torch.tensor(weights)
    if form == "x_prop":
        a, c, v, wb2 = S.rank1_three_feature(net, t, n, True, w)
    else:
        a, c, v, wb2 = S.rank1_two_feature(net, t, 1.0 + n, w)
    comp = S.sweep_plain(leaves[6], a, c, net["W"][1], net["b"][1], v) + wb2
    grads = torch.autograd.grad(torch.sum(torch.sin(comp)), leaves)
    return comp.detach().numpy(), [g.numpy() for g in grads]


def jax_pallas_sweep(form, head, x, nodes, weights):
    """JAX's Pallas sweep of the same head (interpret mode) and the same
    gradients."""
    h = head["W"][0].shape[1]
    name = "gam" if form == "x_prop" else "uz"
    solver = JaxPS(dataclasses.replace(jax_vg(), N=8), SCHEME[form],
                   hidden=(h, h), sweep_impl="pallas")

    def comp_fn(net, xj):
        return solver._pallas_sweep_mean({name: net}, STEP, xj,
                                         jnp.asarray(nodes),
                                         jnp.asarray(weights))

    net = jax.tree_util.tree_map(jnp.asarray, head)
    with jax.default_matmul_precision("highest"):
        comp = comp_fn(net, jnp.asarray(x))
        g_net, g_x = jax.grad(lambda p, xj: jnp.sum(jnp.sin(comp_fn(p, xj))),
                              argnums=(0, 1))(net, jnp.asarray(x))
    grads = [*g_net["W"], *g_net["b"], g_x]
    return np.asarray(comp), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("form", ["x_prop", "two_feature"])
@pytest.mark.parametrize("h,node_set,batch", [
    (8, "quadrature", 256),
    (21, "quadrature", 512),
    (21, "mc", 1000),            # 300 nodes, uniform weights, ragged batch
])
def test_sweep_matches_jax_pallas(form, h, node_set, batch, quadrature):
    args = inputs(form, h, node_set, batch, quadrature)
    got, g_got = port_sweep(form, *args)
    want, g_want = jax_pallas_sweep(form, *args)
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-5 * np.abs(want).max())
    assert rel_norm(g_got, g_want) < 1e-5


def test_two_feature_vectors_equal_jax_packing():
    """(a, c, v, wb2) of ``rank1_two_feature`` are JAX's
    ``pack_two_feature`` vectors without the lane packing."""
    h, m = 21, 13
    rng = np.random.default_rng(7)
    head = head_params(2, h, rng)
    phi = (1.0 + 0.05 * rng.standard_normal(m)).astype(np.float32)
    w = rng.random(m).astype(np.float32)
    phi_g, w_g, p = ps.group_nodes(jnp.asarray(phi), jnp.asarray(w), h)
    a_j, c_j, _, _, v_j, wb2_j = ps.pack_two_feature(
        jax.tree_util.tree_map(jnp.asarray, head), jnp.float32(STEP), phi_g,
        w_g)
    unpack = lambda t: np.asarray(t)[:, :p * h].reshape(-1, h)[:m]
    net = jax.tree_util.tree_map(torch.tensor, head)
    got = S.rank1_two_feature(net, torch.tensor(float(STEP)),
                              torch.tensor(phi), torch.tensor(w))
    for g, want in zip(got[:3], (a_j, c_j, v_j)):
        np.testing.assert_allclose(g.numpy(), unpack(want), rtol=1e-6,
                                   atol=1e-6)
    assert float(got[3]) == pytest.approx(float(wb2_j), rel=1e-6)


@pytest.mark.parametrize("scheme", ["global", "sumlocal1", "sumlocal2"])
def test_rank1_sweep_equals_the_mlp_sweep(scheme, quadrature):
    """Inside the port, the pure-jump solver's rank-1 sweep equals its
    plain sweep of the head over the product grid."""
    ts = TorchPS(dataclasses.replace(torch_vg(), N=8), scheme,
                 hidden=(8, 8), device="cpu")
    params = ts.init_params(torch.Generator().manual_seed(1))
    with torch.no_grad():
        for net in params.values():
            for b in net["b"]:
                b.normal_(0.0, 0.1, generator=torch.Generator().manual_seed(2))
    x = torch.exp(0.2 * torch.randn(300, generator=torch.Generator()
                                    .manual_seed(3)))
    nodes, weights = (torch.tensor(t) for t in quadrature)
    with torch.no_grad():
        rank1 = ts._rank1_sweep_mean(params, STEP, x, nodes, weights)
        plain = ts._sweep_mean(params, STEP, x, nodes, weights)
    np.testing.assert_allclose(rank1.numpy(), plain.numpy(), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("scheme", ["multistep1", "sumlocal1"])
def test_the_one_output_unet_takes_the_kernels(scheme):
    """In the pure-jump regime multistep1/sumlocal1 sweep a U-net of one
    output, which B3/B4 take, so ``sweep_impl="pallas"`` is accepted."""
    ts = TorchPS(dataclasses.replace(torch_vg(), N=2), scheme,
                 hidden=(8, 8), sweep_impl="pallas", device="cpu")
    assert ts.sweep_unmet() == [] and ts.net_specs()["uz"].n_out == 1
