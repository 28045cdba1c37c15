"""The port's rank-1 compensator sweep (ops/sweep.py) against the JAX
package's: ``rank1_three_feature`` + ``sweep_plain`` + wb2 equals JAX's
``_pallas_sweep_mean`` (the Pallas kernel in interpret mode, as on any
machine without a TPU) and its XLA ``_sweep_mean``, values and gradients,
on the 49-node quadrature and a ragged Monte-Carlo node set.  The head's
parameters, the paths and the MC nodes are drawn with numpy from a seed and
handed to both.  The kernels' wrappers refuse CPU tensors, and an unmet
``sweep_impl="pallas"`` precondition raises before anything touches CUDA."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepfbsdejsolvers_torch.models.merton import (
    make_merton_default as torch_merton)
from deepfbsdejsolvers_torch.ops import _build
from deepfbsdejsolvers_torch.ops import sweep as S
from deepfbsdejsolvers_torch.ops.compensator import CompensatorSpec
from deepfbsdejsolvers_torch.solvers.pricing import PricingSolver as TorchPS
from deepfbsdejsolvers_tpu.models.merton import (
    make_merton_default as jax_merton)
from deepfbsdejsolvers_tpu.ops import pallas_sweep as ps
from deepfbsdejsolvers_tpu.solvers.pricing import PricingSolver as JaxPS
from test_torch_pricing import rel_norm

STEP = 5


def head_params(h, rng):
    """A Γ head [t, x, J] → h → h → 1 with non-zero biases, as numpy."""
    sizes = (3, h, h, 1)
    return {"W": [(rng.standard_normal((a, b)) / np.sqrt(a)).astype(
                np.float32) for a, b in zip(sizes[:-1], sizes[1:])],
            "b": [(0.1 * rng.standard_normal(b)).astype(np.float32)
                  for b in sizes[1:]]}


def inputs(h, node_set, batch):
    """(head params, x, nodes, weights or None) from a seeded numpy draw."""
    rng = np.random.default_rng(h * 1000 + batch)
    head = head_params(h, rng)
    x = (1.0 + 0.2 * rng.standard_normal(batch)).astype(np.float32)
    if node_set == "quadrature":
        nodes, weights = (np.asarray(t) for t in
                          torch_merton().jump_quadrature(CompensatorSpec()))
    else:
        nodes = (0.2 * rng.standard_normal(300)).astype(np.float32)
        weights = None
    return head, x, nodes, weights


def port_sweep(head, x, nodes, weights):
    """The port's E_J[Γ] (B,) and its gradients w.r.t. the head and x of
    Σ sin(comp), the probe of tests/test_pallas_sweep.py."""
    leaves = [torch.tensor(t, requires_grad=True)
              for t in (*head["W"], *head["b"], x)]
    gam = {"W": leaves[:3], "b": leaves[3:6]}
    nodes_t = torch.tensor(nodes)
    w = (torch.full_like(nodes_t, 1.0 / len(nodes)) if weights is None
         else torch.tensor(weights))
    a, c, v, wb2 = S.rank1_three_feature(gam, torch.tensor(float(STEP)),
                                         nodes_t, False, w)
    comp = S.sweep_plain(leaves[6], a, c, gam["W"][1], gam["b"][1], v) + wb2
    grads = torch.autograd.grad(torch.sum(torch.sin(comp)), leaves)
    return comp.detach().numpy(), [g.numpy() for g in grads]


def jax_sweep(impl, head, x, nodes, weights):
    """JAX's compensator over the same inputs, the Pallas sweep or the XLA
    sweep of the Γ MLP, and the same gradients.  The XLA sweep runs in
    float64: in f32 on the CPU it takes the gradient of the output weights
    as one contraction over all M·B terms, which at M = 300, B = 1000 lies
    further from float64 than the tolerance, where the Pallas sweep and the
    port do not."""
    h = head["W"][0].shape[1]
    x64 = impl == "xla"
    with jax.enable_x64(x64):
        cast = lambda t: jnp.asarray(t, jnp.float64 if x64 else jnp.float32)
        solver = JaxPS(jax_merton(), "global", hidden=(h, h),
                       sweep_impl=impl)
        nodes_j = cast(nodes)
        w_j = None if weights is None else cast(weights)

        def comp_fn(gam, xj):
            params = {"gam": gam}
            if impl == "pallas":
                return solver._pallas_sweep_mean(params, STEP, xj, nodes_j,
                                                 w_j)
            return solver._sweep_mean(params, STEP, xj, nodes_j, w_j, True)

        gam = jax.tree_util.tree_map(cast, head)
        with jax.default_matmul_precision("highest"):
            comp = comp_fn(gam, cast(x))
            g_gam, g_x = jax.grad(
                lambda p, xj: jnp.sum(jnp.sin(comp_fn(p, xj))),
                argnums=(0, 1))(gam, cast(x))
        grads = [*g_gam["W"], *g_gam["b"], g_x]
        return np.asarray(comp), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("h,node_set,batch", [
    (8, "quadrature", 256),
    (21, "quadrature", 256),
    (8, "mc", 1000),            # 300 nodes, uniform weights, ragged batch
    (21, "mc", 1000),
])
def test_rank1_sweep_matches_jax(impl, h, node_set, batch):
    """Values at rtol 1e-5 (f32 sums over M·H terms in another order; the
    absolute floor 1e-5·max|comp| covers paths whose compensator is near
    zero), and the gradients of every head parameter and of x as one global
    norm at rel 3e-5, the tolerance of the port's other parity tests."""
    args = inputs(h, node_set, batch)
    got, g_got = port_sweep(*args)
    want, g_want = jax_sweep(impl, *args)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    assert rel_norm(g_got, g_want) < 3e-5


@pytest.mark.parametrize("x_prop", [False, True])
def test_rank1_vectors_equal_jax_packing(x_prop):
    """(a, c, v, wb2) are JAX's packed vectors without the lane packing."""
    h, m = 21, 13
    rng = np.random.default_rng(7)
    head = head_params(h, rng)
    feat = rng.standard_normal(m).astype(np.float32)
    w = rng.random(m).astype(np.float32)
    nodes_g, w_g, p = ps.group_nodes(jnp.asarray(feat), jnp.asarray(w), h)
    a_j, c_j, _, _, v_j, wb2_j = ps.pack_three_feature(
        jax.tree_util.tree_map(jnp.asarray, head), jnp.float32(STEP),
        nodes_g, x_prop, w_g)
    unpack = lambda t: np.asarray(t)[:, :p * h].reshape(-1, h)[:m]
    gam = jax.tree_util.tree_map(torch.tensor, head)
    got = S.rank1_three_feature(gam, torch.tensor(float(STEP)),
                                torch.tensor(feat), x_prop, torch.tensor(w))
    for g, want in zip(got[:3], (a_j, c_j, v_j)):
        np.testing.assert_allclose(g.numpy(), unpack(want), rtol=1e-6,
                                   atol=1e-6)
    assert float(got[3]) == pytest.approx(float(wb2_j), rel=1e-6)


def test_both_sweeps_scale_the_time_feature():
    """The rank-1 sweep feeds the head i·time_scale, as the MLP sweep and
    the realized-jump Γ do.  (The JAX package's ``_pallas_sweep_mean``
    feeds it i alone, so at time_scale != 1 its two sweeps differ.)"""
    head, x, nodes, weights = inputs(8, "quadrature", 64)
    s = TorchPS(dataclasses.replace(torch_merton(), N=3), "global",
                hidden=(8, 8), time_scale=0.5, device="cpu")
    params = {"gam": jax.tree_util.tree_map(torch.tensor, head)}
    args = (params, STEP, torch.tensor(x), torch.tensor(nodes),
            torch.tensor(weights))
    rank1 = s._rank1_sweep_mean(*args)
    np.testing.assert_allclose(rank1.numpy(), s._sweep_mean(*args).numpy(),
                               rtol=1e-5, atol=1e-6)
    unscaled = dataclasses.replace(s, time_scale=1.0)._rank1_sweep_mean(*args)
    assert not torch.allclose(rank1, unscaled, rtol=1e-3)


def test_cpu_dispatch_is_the_plain_sweep():
    head, x, nodes, _ = inputs(8, "mc", 100)
    rng = np.random.default_rng(1)
    a, c, v = (torch.tensor(rng.standard_normal((len(nodes), 8)),
                            dtype=torch.float32) for _ in range(3))
    w1, b1 = torch.tensor(head["W"][1]), torch.tensor(head["b"][1])
    xt = torch.tensor(x)
    assert torch.equal(S.fused_sweep(xt, a, c, w1, b1, v),
                       S.sweep_plain(xt, a, c, w1, b1, v))


def test_kernel_wrappers_refuse_cpu_tensors_without_building():
    """B3 and B4 validate before they build or launch anything."""
    before = (S.b3_forward.launches, S.b4_backward.launches)
    x = torch.ones(300)
    a = torch.zeros(49, 21)
    w1, b1 = torch.zeros(21, 21), torch.zeros(21)
    with pytest.raises(ValueError, match="CUDA tensors"):
        S.b3_forward(x, a, a, w1, b1, a)
    with pytest.raises(ValueError, match="CUDA tensors"):
        S.b4_backward(x, a, a, w1, b1, a, x)
    assert (S.b3_forward.launches, S.b4_backward.launches) == before
    assert "sweep_fwd" not in _build._LOADED
    assert "sweep_bwd" not in _build._LOADED


def test_b4_partials_are_bounded_independently_of_the_batch():
    """One block per 256-path tile (128 threads of two paths), at most 512:
    every block walks at least one tile, as the kernel requires."""
    assert [S.b4_blocks(b) for b in (
        1, 128, 129, 256, 257, 1000, 2**17, 2**20)] == [
        1, 1, 1, 1, 2, 4, 512, 512]
    h, m = 21, 5000
    blocks, per_block = S.b4_partial_shape(2**20, m, h)
    assert blocks == S.b4_blocks(2**20)
    assert per_block == h * h + h + 3 * m * h
    assert blocks * per_block <= 512 * (h * h + h + 3 * m * h)


@pytest.mark.parametrize("h", [8, 21, 20, 64, 100, 128])
@pytest.mark.parametrize("m,batch", [
    (1, 1), (17, 37), (49, 1025), (49, 2**17), (5000, 2**12 + 37),
    (5000, 2**17), (5000, 2**20)])
def test_b4_scratch_stays_within_its_bound(m, batch, h):
    """Every block walks at least one tile, and the partial buffer holds at
    most 512 (the specialised B4 at 8 and 21) or 264 (the wide B4
    elsewhere) × (H² + H + 3·M·H) floats, at any batch and node count."""
    tile, most = (256, 512) if h in (8, 21) else (S.b4_wide_tile(), 264)
    blocks, per_block = S.b4_partial_shape(batch, m, h)
    assert per_block == h * h + h + 3 * m * h
    assert 1 <= blocks <= -(-batch // tile)
    assert blocks * per_block <= most * (h * h + h + 3 * m * h)


@pytest.mark.parametrize("batch,m,fits", [
    (2**31 - 256, 49, True), (2**31 - 255, 49, False),
    (2**17, (2**31 - 256 - 462) // 63, True),
    (2**17, (2**31 - 256 - 462) // 63 + 1, False)])
def test_sizes_past_the_kernels_32_bit_indices_raise(batch, m, fits):
    """Paths and B4's partial rows (H² + H + 3·M·H = 462 + 63·M floats at
    H = 21) are indexed in 32-bit ints up to the end of their last tile of
    256, so sizes past that raise before anything builds or launches."""
    if fits:
        S._check_sizes(batch, m, 21)
    else:
        with pytest.raises(ValueError, match="32-bit"):
            S._check_sizes(batch, m, 21)
    assert "sweep_fwd" not in _build._LOADED
    assert "sweep_bwd" not in _build._LOADED


def test_parity_configuration_builds_with_the_defaults():
    s = TorchPS(torch_merton(), "global", sweep_impl="pallas", device="cpu")
    assert not s.hoist and s.compensator == CompensatorSpec()
    assert s.sweep_unmet() == []
    assert s._quad[0].shape == (49,)


@pytest.mark.parametrize("kw,match", [
    (dict(hidden=(129, 129)), "two equal layers"),
    (dict(hidden=(8, 21)), "two equal layers"),
    (dict(hidden=(8, 8, 8)), "two equal layers"),
    (dict(activation="relu"), "activation"),
    (dict(compute_dtype="bfloat16"), "compute_dtype"),
])
def test_sweep_preconditions_raise_before_touching_cuda(kw, match):
    """An unmet precondition of the sweep kernels raises ValueError at
    construction on device="cuda", before any allocation: on a machine
    without a card the first CUDA allocation would raise something else."""
    args = dict(dict(hidden=(8, 8)), **kw)
    with pytest.raises(ValueError, match=match):
        TorchPS(dataclasses.replace(torch_merton(), N=3), "global",
                sweep_impl="pallas", device="cuda", **args)


def test_sweep_kernels_take_a_shard_of_the_nodes():
    """Under compensator sharding B3/B4 sweep each rank's slice of the
    49-node quadrature, padded with a zero-weight node to 50."""
    s = TorchPS(torch_merton(), "global", sweep_impl="pallas", device="cpu",
                comp_axis="comp", comp_shards=2)
    assert s.sweep_unmet() == []
    assert s._quad[0].shape == (50,) and float(s._quad[1][-1]) == 0.0
