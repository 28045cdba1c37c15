"""The chunked time loop (``ops/scan.py``) against the JAX package's
``chunked_scan`` (tests/test_scan_ops.py's cases: every chunk, the
length-only idiom, length one, JAX's named-save policy), and the solvers with
``scan_chunk`` against the plain loop: loss and every gradient bit for bit,
and against the JAX package's chunked scan at the parity tests' tolerances
(loss rel 1e-5, grads rel 3e-5)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepfbsdejsolvers_torch.models.merton import (
    make_merton_default as torch_merton)
from deepfbsdejsolvers_torch.nets.mlp import param_leaves
from deepfbsdejsolvers_torch.ops.compensator import CompensatorSpec
from deepfbsdejsolvers_torch.ops.scan import chunk_size, chunked_scan
from deepfbsdejsolvers_torch.solvers.pricing import PricingSolver
from deepfbsdejsolvers_tpu.ops.scan import chunked_scan as jax_chunked_scan
from test_torch_mfg_losses import SMALL, assert_pair_matches
from test_torch_mfg_losses import make_pair as mfg_pair
from test_torch_schemes import assert_loss_and_grads_match, make_pair

CHEB16 = dict(x_interp="chebyshev", n_cheb=16)
SPEED_MODEL = dict(jump_sampler="icdf", price_mode="chebyshev")


def _torch_body(c, x):
    return (c * 0.9 + x["a"] + 0.1 * torch.sum(x["b"]),
            {"y": c + x["a"], "z": c - x["b"]})


def _jax_body(c, x):
    return (c * 0.9 + x["a"] + 0.1 * jnp.sum(x["b"]),
            {"y": c + x["a"], "z": c - x["b"]})


def _xs(length, mod):
    return {"a": mod.arange(length, dtype=mod.float32),
            "b": mod.ones((length, 3), dtype=mod.float32)}


@pytest.mark.parametrize("chunk", [0, 1, 2, 3, 4, 5, 6, 12, 99])
def test_matches_jax_for_every_chunk(chunk):
    """The carry and the stacked outputs of every chunk equal JAX's and
    the port's plain loop's (exactly here: no op is fused)."""
    c, ys = chunked_scan(_torch_body, torch.tensor(1.0), _xs(12, torch), 12,
                         chunk, remat=True)
    c0, ys0 = chunked_scan(_torch_body, torch.tensor(1.0), _xs(12, torch),
                           12, 0)
    cj, ysj = jax_chunked_scan(_jax_body, jnp.float32(1.0), _xs(12, jnp), 12,
                               chunk)
    assert torch.equal(c, c0)
    assert float(c) == pytest.approx(float(cj), rel=1e-6)
    for k in ("y", "z"):
        assert torch.equal(ys[k], ys0[k])
        np.testing.assert_allclose(ys[k].numpy(), np.asarray(ysj[k]),
                                   rtol=1e-6)


def test_chunk_size_is_jax_s_largest_divisor():
    # 7 on N = 50 takes 5, 2 on an odd length degrades to a step a chunk
    assert [chunk_size(50, k) for k in (0, 1, 2, 5, 7, 16, 50, 99)] == [
        1, 1, 2, 5, 5, 10, 1, 1]
    assert chunk_size(47, 2) == 1 and chunk_size(12, 5) == 4


def test_length_only_idiom_and_length_one():
    """xs None: the body gets None and the length alone drives the loop."""
    body_t = lambda c, _: (c * 2.0 + 1.0, c)
    body_j = lambda c, _: (c * 2.0 + 1.0, c)
    for length, chunk in ((6, 2), (6, 4), (1, 2)):
        c, ys = chunked_scan(body_t, torch.tensor(0.5), None, length, chunk,
                             remat=True)
        cj, ysj = jax_chunked_scan(body_j, jnp.float32(0.5), None, length,
                                   chunk)
        assert float(c) == float(cj)
        np.testing.assert_array_equal(ys.numpy(), np.asarray(ysj))


@pytest.mark.parametrize("length", [10, 9])
def test_gradients_bit_identical_under_remat(length):
    """Chunks checkpointed leave the gradients of the plain loop bit for
    bit (on the odd length, chunk 2 degrades to a step a chunk), and equal
    those of JAX's chunked scan under its pricing solver's policy, which
    saves the named "gam", to 1e-6."""

    def body(c, x):
        h = torch.tanh(c + x)
        return c + h, h

    def loss(chunk, remat):
        th = torch.tensor(0.3, requires_grad=True)
        c, ys = chunked_scan(body, th, torch.linspace(0.0, 1.0, length),
                             length, chunk, remat=remat)
        return torch.autograd.grad(c + ys.sum(), th)[0]

    g = loss(0, False)
    assert all(torch.equal(loss(k, True), g) for k in (0, 2, 3, 5))
    jpol = jax.checkpoint_policies.save_only_these_names("gam")

    def jloss(theta):
        from jax.ad_checkpoint import checkpoint_name as jname

        body_j = lambda c, x: (c + jname(jnp.tanh(c + x), "gam"),
                               jname(jnp.tanh(c + x), "gam"))
        c, ys = jax_chunked_scan(body_j, theta,
                                 jnp.linspace(0.0, 1.0, length), length, 2,
                                 remat=True, policy=jpol)
        return c + jnp.sum(ys)

    assert float(g) == pytest.approx(float(jax.grad(jloss)(
        jnp.float32(0.3))), rel=1e-6)


def _loss_and_grads(solver, batch=64):
    p = solver.init_params(torch.Generator().manual_seed(0))
    for t in param_leaves(p):
        t.requires_grad_(True)
    loss = solver.build_loss(batch)(p, torch.Generator().manual_seed(1))
    return loss.detach(), torch.autograd.grad(loss, param_leaves(p))


HOISTED = dict(compensator=CompensatorSpec(**CHEB16), hoist=True,
               hoist_interp="piecewise")


@pytest.mark.parametrize("scheme,kw,chunk", [
    ("global", HOISTED, 2), ("global", HOISTED, 7),
    ("global", {}, 3), ("multistep1", HOISTED, 5),
    ("sumlocal2", dict(sweep_impl="pallas"), 4),
    ("global", dict(compensator=CompensatorSpec(kind="mc", n_mc=24,
                                                node_block=10)), 5),
])
def test_pricing_scan_chunk_is_the_plain_loop_bit_for_bit(scheme, kw,
                                                           chunk):
    model = torch_merton(**(SPEED_MODEL if kw.get("hoist") else {}))
    base = PricingSolver(dataclasses.replace(model, N=10), scheme,
                         hidden=(8, 8), device="cpu", **kw)
    flat = _loss_and_grads(base)
    got = _loss_and_grads(dataclasses.replace(base, scan_chunk=chunk))
    assert torch.equal(got[0], flat[0])
    assert all(torch.equal(a, b) for a, b in zip(got[1], flat[1]))


@pytest.mark.parametrize("scheme", ["global", "multistep1"])
def test_pricing_scan_chunk_matches_jax(scheme):
    """JAX's chunked scan at scan_chunk=2 (N = 3 takes a step a chunk)."""
    js, ts, jparams = make_pair(scheme, comp=CHEB16, model=SPEED_MODEL,
                                hoist=True, hoist_interp="piecewise",
                                scan_chunk=2)
    assert_loss_and_grads_match(js, ts, jparams)


@pytest.mark.parametrize("scheme,chunk", [("global", 4), ("sumlocal", 6),
                                          ("multistep", 5)])
def test_mfg_scan_chunk_is_the_plain_loop_bit_for_bit(scheme, chunk):
    """N = 12: chunks of 4, 6 and 4 steps (5 takes 4)."""
    _, flat, _ = mfg_pair(scheme, **SMALL)
    chunked = dataclasses.replace(flat, scan_chunk=chunk)
    res = []
    for solver in (flat, chunked):
        p = solver.init_params(torch.Generator().manual_seed(0))
        for t in param_leaves(p):
            t.requires_grad_(True)
        loss = solver.build_losses(32)["coupled"](
            p, torch.Generator().manual_seed(1))
        res.append((loss.detach(), torch.autograd.grad(loss,
                                                       param_leaves(p))))
    assert torch.equal(res[0][0], res[1][0])
    assert all(torch.equal(a, b) for a, b in zip(res[0][1], res[1][1]))


def test_mfg_scan_chunk_matches_jax():
    js, ts, jparams = mfg_pair("sumlocal", scan_chunk=4, **SMALL)
    assert_pair_matches(js, ts, jparams)
