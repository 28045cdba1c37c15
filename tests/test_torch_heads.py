"""The heads' opt-in forms against the JAX package: bf16 matmuls
(``compute_dtype="bfloat16"``) and the MFG solver's block-diagonal fused
heads (``fuse_heads``).

bf16: the MLP's forward equals JAX's ``mlp_apply`` to 1e-6 of its largest
output (both round the same bf16 products), its VJP within 4e-2 of each
leaf's largest entry (bf16 sums of a thousand terms, in two orders); the
solvers' losses within 1e-5 of JAX's at shared params and noise, and within
5e-3 of the f32 loss (tests/test_fast_paths.py's bound).  fuse_heads: JAX's
pair losses within 1e-5 and gradients 3e-5 (tests/test_torch_mfg_losses.py),
and the split heads' loss within 1e-6 and gradients 1e-5
(tests/test_fast_paths.py)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepfbsdejsolvers_torch.nets.mlp import mlp_apply, param_leaves
from deepfbsdejsolvers_tpu.nets.mlp import mlp_apply as jax_mlp_apply
from test_torch_mfg_losses import SMALL, assert_pair_matches, jax_noise
from test_torch_mfg_losses import make_pair as mfg_pair
from test_torch_pricing import port_params, rel_norm
from test_torch_schemes import jax_noise as pricing_noise
from test_torch_schemes import make_pair

SPEED = dict(comp=dict(x_interp="chebyshev", n_cheb=16),
             model=dict(jump_sampler="icdf", price_mode="chebyshev"),
             hoist=True, hoist_interp="piecewise")


def _head(seed=0):
    rng = np.random.default_rng(seed)
    shapes = ((3, 21), (21, 21), (21, 1))
    ws = [0.5 * rng.normal(size=s).astype(np.float32) for s in shapes]
    bs = [0.1 * rng.normal(size=s[1]).astype(np.float32) for s in shapes]
    x = rng.normal(size=(1000, 3)).astype(np.float32)
    g = rng.normal(size=(1000, 1)).astype(np.float32)
    return ws, bs, x, g


def test_bf16_mlp_matches_jax():
    ws, bs, x, g = _head()
    tp = {"W": [torch.tensor(w, requires_grad=True) for w in ws],
          "b": [torch.tensor(b, requires_grad=True) for b in bs]}
    out = mlp_apply(tp, torch.tensor(x), torch.tanh, torch.bfloat16)
    assert out.dtype == torch.float32
    jp = {"W": [jnp.asarray(w) for w in ws], "b": [jnp.asarray(b) for b in bs]}
    want = np.asarray(jax_mlp_apply(jp, jnp.asarray(x),
                                    compute_dtype=jnp.bfloat16))
    np.testing.assert_allclose(out.detach().numpy(), want,
                               atol=1e-6 * np.abs(want).max())
    f32 = mlp_apply(tp, torch.tensor(x)).detach().numpy()
    assert 1e-3 < np.abs(out.detach().numpy() - f32).max() < 5e-2
    got = torch.autograd.grad(out, tp["W"] + tp["b"], torch.tensor(g))
    gj = jax.grad(lambda p: jnp.sum(jax_mlp_apply(
        p, jnp.asarray(x), compute_dtype=jnp.bfloat16) * g))(jp)
    for a, b in zip(got, gj["W"] + gj["b"]):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, atol=4e-2 * np.abs(b).max())


@pytest.mark.parametrize("scheme,kw", [("multistep2", {}),
                                       ("global", SPEED)])
def test_bf16_pricing_loss_matches_jax_and_f32(scheme, kw):
    js, ts, jparams = make_pair(scheme, compute_dtype="bfloat16", **kw)
    key, batch = jax.random.key(11), 256
    lj = float(jax.jit(js.build_loss(batch))(jparams, key))
    noise = pricing_noise(js, key, batch)
    p = port_params(jparams)
    lt = ts.build_loss_from_noise(batch)(p, noise)
    assert float(lt.detach()) == pytest.approx(lj, rel=1e-5)
    l32 = dataclasses.replace(ts, compute_dtype=None).build_loss_from_noise(
        batch)(p, noise)
    assert float(lt.detach()) == pytest.approx(float(l32.detach()),
                                               rel=5e-3)
    grads = torch.autograd.grad(lt, param_leaves(p))
    assert all(bool(torch.isfinite(g).all()) for g in grads)


@pytest.mark.parametrize("scheme", ["global", "sumlocal"])
def test_bf16_mfg_pair_loss_matches_jax(scheme):
    js, ts, jparams = mfg_pair(scheme, compute_dtype="bfloat16", **SMALL)
    key, batch = jax.random.key(11), 256
    want = jax.jit(js.build_pair_loss(batch))(jparams, key)
    noise, _ = jax_noise(js, key, batch)
    got = ts.build_pair_loss_from_noise(batch)(port_params(jparams), noise)
    for a, b in zip(got, want):
        assert float(a.detach()) == pytest.approx(float(b), rel=1e-5)


@pytest.mark.parametrize("scheme", ["global", "sumlocal"])
def test_fused_heads_match_jax(scheme):
    js, ts, jparams = mfg_pair(scheme, fuse_heads=True, **SMALL)
    assert ts._can_fuse_heads()
    assert_pair_matches(js, ts, jparams)


@pytest.mark.parametrize("scheme", ["global", "multistep", "sumlocal",
                                    "sumlocal_reg", "multistep_reg"])
def test_fused_heads_match_split_heads(scheme):
    """Block-diagonal weights keep the two heads apart: the same pair loss
    and gradients at the reference's widths (hidden (20, 20) / (22, 22))."""
    _, split, jparams = mfg_pair(scheme)
    fused = dataclasses.replace(split, fuse_heads=True)
    res = []
    for solver in (split, fused):
        p = port_params(jparams)
        loss = solver.build_losses(64)["coupled"](
            p, torch.Generator().manual_seed(2))
        res.append((float(loss.detach()), [g.numpy() for g in
                                           torch.autograd.grad(
                                               loss, param_leaves(p))]))
    assert res[1][0] == pytest.approx(res[0][0], rel=1e-6)
    assert rel_norm(res[1][1], res[0][1]) < 1e-5


def test_fused_heads_fall_back_to_split_heads():
    """Heads of two depths, or two activations, run apart."""
    _, ts, _ = mfg_pair("global", fuse_heads=True, hidden_hat=(8, 8),
                        hidden=(8, 8, 8))
    assert not ts._can_fuse_heads()
    _, ts, _ = mfg_pair("global", fuse_heads=True, activation_hat="relu",
                        **SMALL)
    assert not ts._can_fuse_heads()
    p = port_params(mfg_pair("global", **SMALL)[2])
    ws = [w.detach() for w in ts._fused_weights(p)["W"]]
    assert [tuple(w.shape) for w in ws] == [(10, 16), (16, 16), (16, 5)]
    assert float(ws[0][:4, 8:].abs().sum() + ws[0][4:, :8].abs().sum()) == 0
