"""The port's collocation ops equal the JAX package's: piecewise nodes, fit,
evaluation and derivative (with clamping past the interval), the global
Chebyshev interpolant, and the compensator's quadrature rule.  The piece
select (``select_rows``, a gather whose backward is the one-hot product
one_hot(k)ᵀ·ḡ, as the JAX package's one-hot matmul differentiates) gives
JAX's gradients with respect to the table and the points, the old plain
gather's forward bit for bit, and the same bits on every backward run."""

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


SELECT_CASES = {
    # points strictly inside [LO, HI], every piece hit
    "interior": lambda x: x[(x > LO) & (x < HI)],
    # points past both ends, which clamp to the end pieces (a point on an
    # end is left out: there torch.clamp and jnp.clip take different
    # subgradients, whatever the select)
    "clamped": lambda x: np.concatenate(
        [x[(x < LO) | (x > HI)],
         np.array([LO - 1.0, LO - 1e-3, HI + 1e-3, HI + 2.0], np.float32)]),
}


def _select_args(case):
    _, coef = _coef()
    x = SELECT_CASES[case](_x()).astype(np.float32)
    rng = np.random.default_rng(7)
    w = rng.standard_normal((2, x.size)).astype(np.float32)
    return coef, x, w


@pytest.mark.parametrize("case", sorted(SELECT_CASES))
def test_select_grads_equal_jax(case):
    """The value and the gradients with respect to the table and the points
    of pw_eval and pw_eval_with_deriv equal JAX's (its one-hot matmul
    select), at the tolerances of the evaluation test above."""
    coef, x, w = _select_args(case)
    lo, hi = jnp.asarray(LO), jnp.asarray(HI)

    def jax_loss(c, xx):
        val, dval = jp.pw_eval_with_deriv(c, xx, lo, hi)
        return (jnp.sum(w[0] * jp.pw_eval(c, xx, lo, hi))
                + jnp.sum(w[1] * (val + dval)))

    with jax.default_matmul_precision("highest"):
        jgc, jgx = jax.grad(jax_loss, argnums=(0, 1))(jnp.asarray(coef),
                                                      jnp.asarray(x))
    tc = torch.tensor(coef, requires_grad=True)
    tx = torch.tensor(x, requires_grad=True)
    tw = torch.tensor(w)
    tlo, thi = torch.tensor(LO), torch.tensor(HI)
    val, dval = tp.pw_eval_with_deriv(tc, tx, tlo, thi)
    value = tp.pw_eval(tc, tx, tlo, thi)
    np.testing.assert_allclose(
        value.detach().numpy(),
        np.asarray(jp.pw_eval(jnp.asarray(coef), jnp.asarray(x), lo, hi)),
        rtol=1e-6, atol=1e-7)
    loss = torch.sum(tw[0] * value) + torch.sum(tw[1] * (val + dval))
    gc, gx = torch.autograd.grad(loss, [tc, tx])
    np.testing.assert_allclose(gc.numpy(), np.asarray(jgc), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(gx.numpy(), np.asarray(jgx), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("case", sorted(SELECT_CASES))
def test_select_forward_is_the_gather_bit_for_bit(case):
    coef, x, _ = _select_args(case)
    ct, xt = torch.tensor(coef), torch.tensor(x)
    lo, hi = torch.tensor(LO), torch.tensor(HI)
    p = ct.shape[-2]
    s = torch.clamp((xt - lo) / torch.clamp(hi - lo, min=1e-6), 0.0, 1.0) * p
    k = torch.clamp(torch.floor(s), 0, p - 1).long()
    assert torch.equal(tp.select_rows(ct, k), ct[k])
    rows, t, _, _ = tp._locate(ct, xt, lo, hi)
    assert torch.equal(rows, ct[k])
    assert torch.equal(tp.pw_eval(ct, xt, lo, hi), tc.cheb_series(ct[k], t))


@pytest.mark.parametrize("case", sorted(SELECT_CASES))
def test_select_backward_is_deterministic_and_one_hot(case):
    """Two backward runs give the same bits, and the table's cotangent is
    one_hot(k)ᵀ·ḡ: each piece's row is the sum of its points' ḡ rows."""
    coef, x, w = _select_args(case)
    tlo, thi = torch.tensor(LO), torch.tensor(HI)
    tw = torch.tensor(w[0])

    def grads():
        tc = torch.tensor(coef, requires_grad=True)
        tx = torch.tensor(x, requires_grad=True)
        val, dval = tp.pw_eval_with_deriv(tc, tx, tlo, thi)
        return torch.autograd.grad(torch.sum(tw * (val + dval)), [tc, tx])

    first, second = grads(), grads()
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    tc = torch.tensor(coef)
    k = torch.tensor([0, 3, 3, 7, 7, 7])
    g = torch.tensor(np.random.default_rng(3).standard_normal((6, DEG + 1)),
                     dtype=torch.float32)
    leaf = tc.clone().requires_grad_(True)
    (gc,) = torch.autograd.grad(tp.select_rows(leaf, k), [leaf], g)
    want = torch.zeros_like(tc)
    for row, piece in zip(g, k.tolist()):
        want[piece] += row
    np.testing.assert_allclose(gc.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-7)
    assert torch.equal(gc[[1, 2, 4, 5, 6]], torch.zeros(5, DEG + 1))


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
