"""The port's bias-free walk update equals the JAX package's, in value and
gradient, around 0 and past the |u| = 0.125 Taylor cut."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from deepfbsdejsolvers_torch.ops import numerics as tn
from deepfbsdejsolvers_tpu.ops import numerics as jn

CUT = 0.125
U = np.concatenate([
    np.linspace(-0.3, 0.3, 1201),
    [0.0, 1e-8, -1e-8, 1e-4, -1e-4],
    np.nextafter(np.float32([CUT, -CUT]), np.float32(0)),
    [CUT, -CUT],
    np.nextafter(np.float32([CUT, -CUT]), np.float32([1, -1])),
]).astype(np.float32)
X = np.random.default_rng(0).uniform(0.2, 3.0, U.shape).astype(np.float32)


def _close(a, b, rel=1e-6):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rel,
                               atol=1e-30)


def test_expm1_acc_values_and_grads_match_jax():
    _close(tn.expm1_acc(torch.tensor(U)), jn.expm1_acc(jnp.asarray(U)))
    _close(tn.expm1_taylor7(torch.tensor(U[np.abs(U) < CUT])),
           jn.expm1_taylor7(jnp.asarray(U[np.abs(U) < CUT])))
    u = torch.tensor(U, requires_grad=True)
    (g,) = torch.autograd.grad(tn.expm1_acc(u).sum(), u)
    gj = jax.grad(lambda v: jnp.sum(jn.expm1_acc(v)))(jnp.asarray(U))
    _close(g, gj)


def test_mul_exp_values_and_grads_match_jax():
    _close(tn.mul_exp(torch.tensor(X), torch.tensor(U)),
           jn.mul_exp(jnp.asarray(X), jnp.asarray(U)))
    x = torch.tensor(X, requires_grad=True)
    u = torch.tensor(U, requires_grad=True)
    gx, gu = torch.autograd.grad(tn.mul_exp(x, u).sum(), (x, u))
    gxj, guj = jax.grad(lambda a, b: jnp.sum(jn.mul_exp(a, b)),
                        argnums=(0, 1))(jnp.asarray(X), jnp.asarray(U))
    _close(gx, gxj)
    _close(gu, guj)


def test_use_full_f32_turns_tf32_off():
    tn.use_full_f32()
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
