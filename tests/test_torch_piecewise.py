"""The port's collocation ops equal the JAX package's: piecewise nodes, fit,
evaluation and derivative (with clamping past the interval), the global
Chebyshev interpolant, and the compensator's quadrature rule."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepfbsdejsolvers_torch.ops import chebyshev as tc
from deepfbsdejsolvers_torch.ops import compensator as tq
from deepfbsdejsolvers_torch.ops import piecewise as tp
from deepfbsdejsolvers_tpu.ops import chebyshev as jc
from deepfbsdejsolvers_tpu.ops import compensator as jq
from deepfbsdejsolvers_tpu.ops import piecewise as jp

P, DEG = 8, 7
LO, HI = np.float32(0.6), np.float32(1.9)


def _coef():
    """A fitted table of a smooth function on [LO, HI], both frameworks."""
    nodes = jp.pw_nodes(jnp.asarray(LO), jnp.asarray(HI), P, DEG)
    vals = np.asarray(jnp.sin(3.0 * nodes) * jnp.exp(-nodes))
    with jax.default_matmul_precision("highest"):
        jcoef = jp.pw_fit(jnp.asarray(vals), P, DEG)
    return vals, np.asarray(jcoef)


def _x():
    """Points inside, on the edges of, and outside [LO, HI]."""
    rng = np.random.default_rng(0)
    inside = rng.uniform(LO, HI, 500)
    return np.concatenate([inside, [LO, HI, LO - 0.3, HI + 0.4, 0.0, 5.0]]
                          ).astype(np.float32)


def test_nodes_and_fit_equal_jax():
    lo = np.array([0.5, 0.9], np.float32)
    hi = np.array([1.5, 2.9], np.float32)
    np.testing.assert_allclose(
        tp.pw_nodes(torch.tensor(lo), torch.tensor(hi), P, DEG).numpy(),
        np.asarray(jp.pw_nodes(jnp.asarray(lo), jnp.asarray(hi), P, DEG)),
        rtol=1e-7)
    np.testing.assert_array_equal(tp._pw_cheb_fit(DEG), jp._pw_cheb_fit(DEG))
    vals, jcoef = _coef()
    np.testing.assert_allclose(tp.pw_fit(torch.tensor(vals), P, DEG).numpy(),
                               jcoef, rtol=1e-6, atol=1e-7)


def test_eval_and_derivative_equal_jax_with_clamping():
    _, coef = _coef()
    x = _x()
    args_t = (torch.tensor(coef), torch.tensor(x), torch.tensor(LO),
              torch.tensor(HI))
    args_j = (jnp.asarray(coef), jnp.asarray(x), jnp.asarray(LO),
              jnp.asarray(HI))
    np.testing.assert_allclose(tp.pw_eval(*args_t).numpy(),
                               np.asarray(jp.pw_eval(*args_j)),
                               rtol=1e-6, atol=1e-7)
    val, dval = tp.pw_eval_with_deriv(*args_t)
    jval, jdval = jp.pw_eval_with_deriv(*args_j)
    np.testing.assert_allclose(val.numpy(), np.asarray(jval), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(dval.numpy(), np.asarray(jdval), rtol=1e-5,
                               atol=1e-6)
    outside = (x < LO) | (x > HI)
    assert np.all(dval.numpy()[outside] == 0.0)
    # clamped: the value past an edge is the value at the edge
    np.testing.assert_allclose(val.numpy()[x < LO],
                               tp.pw_eval(*args_t).numpy()[x == LO][0])
    # and the hand derivative is autograd's
    xt = torch.tensor(x, requires_grad=True)
    (g,) = torch.autograd.grad(
        tp.pw_eval(args_t[0], xt, *args_t[2:]).sum(), xt)
    np.testing.assert_allclose(g.numpy(), dval.numpy(), rtol=1e-5, atol=1e-6)


def test_chebyshev_interp_equals_jax():
    x = _x()[:500]
    fn_t = lambda v: torch.exp(-v) * torch.cos(2 * v)
    fn_j = lambda v: jnp.exp(-v) * jnp.cos(2 * v)
    got = tc.interp_1d(fn_t, torch.tensor(x), 32).numpy()
    want = np.asarray(jc.interp_1d(fn_j, jnp.asarray(x), 32))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("spec_kw", [{}, {"n_poisson_max": 8, "n_hermite": 16}])
def test_quadrature_equals_jax(spec_kw):
    got = tq.compound_poisson_quadrature(0.06, 0.0, 0.2,
                                         tq.CompensatorSpec(**spec_kw))
    want = jq.compound_poisson_quadrature(0.06, 0.0, 0.2,
                                          jq.CompensatorSpec(**spec_kw))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    vals = np.random.default_rng(1).standard_normal((got[0].size, 7)
                                                    ).astype(np.float32)
    np.testing.assert_allclose(
        tq.compensated_mean(torch.tensor(vals), torch.tensor(got[1])).numpy(),
        np.asarray(jq.compensated_mean(jnp.asarray(vals),
                                       jnp.asarray(want[1]))), rtol=1e-6,
        atol=1e-7)
