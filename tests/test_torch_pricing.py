"""The port's hoisted global loss equals the JAX package's at fixed params and
noise: the per-step tables, the loss (rel 1e-5) and the gradients of every
parameter as one global norm (rel 3e-5), the tolerances of
tests/test_pallas_rollout.py.  The JAX side runs its XLA scan
(fused_rollout=False) at full f32 matmul precision; the noise is drawn by
JAX's ``_prenoise`` and handed to the port as tensors, since torch's
generators cannot reproduce threefry."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepfbsdejsolvers_torch.models.merton import (
    make_merton_default as torch_merton)
from deepfbsdejsolvers_torch.nets.mlp import mlp_apply, param_leaves
from deepfbsdejsolvers_torch.ops.compensator import (
    CompensatorSpec as TorchComp)
from deepfbsdejsolvers_torch.solvers.pricing import PricingSolver as TorchPS
from deepfbsdejsolvers_torch.utils.convert import (
    params_from_jax, params_to_jax)
from deepfbsdejsolvers_tpu.models.merton import (
    make_merton_default as jax_merton)
from deepfbsdejsolvers_tpu.nets.mlp import mlp_apply as jax_mlp_apply
from deepfbsdejsolvers_tpu.ops.compensator import CompensatorSpec as JaxComp
from deepfbsdejsolvers_tpu.solvers.pricing import PricingSolver as JaxPS

N = 3


def make_pair(a_lin=0.1, hidden=(8, 8), fused=True, interp="piecewise"):
    """(JAX solver, port solver on the CPU, JAX params) for one config."""
    kw = dict(hoist=True, hoist_interp=interp, hidden=hidden)
    jm = dataclasses.replace(jax_merton(a_lin=a_lin, jump_sampler="icdf",
                                        price_mode="chebyshev"), N=N)
    tm = dataclasses.replace(torch_merton(a_lin=a_lin, jump_sampler="icdf",
                                          price_mode="chebyshev"), N=N)
    js = JaxPS(jm, "global", compensator=JaxComp(x_interp="chebyshev",
                                                 n_cheb=64), **kw)
    ts = TorchPS(tm, "global", compensator=TorchComp(x_interp="chebyshev",
                                                     n_cheb=64),
                 fused_rollout=fused, device="cpu", **kw)
    return js, ts, js.init_params(jax.random.key(3))


def port_params(jparams):
    p = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    for t in param_leaves(p):
        t.requires_grad_(True)
    return p


def jax_noise(js, key, batch):
    dw, j, _ = js._prenoise(key, batch)
    return dw, j, (torch.tensor(np.asarray(dw)), torch.tensor(np.asarray(j)))


def rel_norm(a, b):
    num = np.sqrt(sum(np.sum((x - y) ** 2) for x, y in zip(a, b)))
    return num / np.sqrt(sum(np.sum(y ** 2) for y in b))


def test_params_round_trip_and_mlp_apply_equal_jax():
    js, _, jparams = make_pair(hidden=(21, 21))
    p = port_params(jparams)
    back = params_to_jax(p)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(jparams)):
        np.testing.assert_array_equal(a, np.asarray(b))
    x = np.random.default_rng(0).standard_normal((5, 7, 3)).astype(np.float32)
    got = mlp_apply(p["gam"], torch.tensor(x)).detach().numpy()
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax_mlp_apply(jparams["gam"], jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_hoisted_tables_equal_jax():
    js, ts, jparams = make_pair()
    dw, j, noise = jax_noise(js, jax.random.key(11), 1024)
    with jax.default_matmul_precision("highest"):
        want = jax.jit(js._hoist_tables)(jparams, (dw, j, None))
    got = ts._hoist_tables(port_params(jparams), noise)
    for name in ("lo", "hi", "cc", "pc", "zc"):
        w = np.asarray(want[name])
        np.testing.assert_allclose(got[name].detach().numpy(), w, rtol=1e-6,
                                   atol=1e-6 * np.abs(w).max(), err_msg=name)


@pytest.mark.parametrize("a_lin,hidden,batch,fused,interp", [
    (0.1, (8, 8), 1024, True, "piecewise"),
    (0.0, (8, 8), 1024, True, "piecewise"),
    (0.1, (21, 21), 1024, True, "piecewise"),
    (0.1, (8, 8), 1000, True, "piecewise"),      # ragged batch
    (0.1, (8, 8), 1024, False, "piecewise"),     # the plain loop
    (0.1, (8, 8), 1024, False, "clenshaw"),      # global Chebyshev tables
])
def test_loss_and_grads_match_jax(a_lin, hidden, batch, fused, interp):
    js, ts, jparams = make_pair(a_lin, hidden, fused, interp)
    key = jax.random.key(11)
    with jax.default_matmul_precision("highest"):
        lj, gj = jax.jit(jax.value_and_grad(js.build_loss(batch)))(jparams,
                                                                   key)
    _, _, noise = jax_noise(js, key, batch)
    p = port_params(jparams)
    lt = ts.build_loss_from_noise(batch)(p, noise)
    gt = torch.autograd.grad(lt, param_leaves(p))
    assert float(lt.detach()) == pytest.approx(float(lj), rel=1e-5)
    rel = rel_norm([g.numpy() for g in gt],
                   [np.asarray(g) for g in jax.tree_util.tree_leaves(gj)])
    assert rel < 3e-5, rel
    # every head receives gradient, the UZ head only through the tables
    n_gam = len(param_leaves(p["gam"]))
    for grads in (gt[:n_gam], gt[n_gam:]):
        assert sum(float(g.abs().sum()) for g in grads) > 0


def test_noise_shape_is_checked():
    _, ts, jparams = make_pair()
    loss = ts.build_loss_from_noise(64)
    bad = torch.zeros((N, 32))
    with pytest.raises(ValueError, match="noise must be"):
        loss(port_params(jparams), (bad, bad))
