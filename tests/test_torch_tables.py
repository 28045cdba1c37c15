"""The hoisted global rollout's table options against the JAX package, at
shared params and noise (N = 3, hidden (8, 8)): the 2-D Γ tables
(``ops/piecewise.py`` ``pw2_*``, ``hoist_gamma``), the Z head evaluated in
the loop (``hoist_z=False``), Merton's ``price_mode="table"`` and a price
that is not collocated under ``hoist=True``.  The losses within 1e-5 and
the gradients within 3e-5 relative (tests/test_torch_schemes.py); the
tables within 1e-6 of their largest entry; the Γ tables' loss within 5e-4
of the loss without them (the JAX package's bound,
tests/test_fast_paths.py)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepfbsdejsolvers_torch.models.merton import (
    make_merton_default as torch_merton)
from deepfbsdejsolvers_torch.ops import piecewise as TP
from deepfbsdejsolvers_tpu.models.merton import (
    make_merton_default as jax_merton)
from deepfbsdejsolvers_tpu.ops import piecewise as JP
from test_torch_pricing import port_params
from test_torch_schemes import assert_loss_and_grads_match, make_pair

CHEB16 = dict(x_interp="chebyshev", n_cheb=16)
SPEED_MODEL = dict(jump_sampler="icdf", price_mode="chebyshev")
HOIST = dict(hoist=True, hoist_interp="piecewise")
PX, DX, PJ, DJ = 8, 7, 4, 4


def _grid(seed=0):
    rng = np.random.default_rng(seed)
    lo = rng.uniform(0.4, 0.8, 3).astype(np.float32)
    hi = lo + rng.uniform(0.8, 1.6, 3).astype(np.float32)
    jlo = -rng.uniform(0.2, 0.6, 3).astype(np.float32)
    jhi = rng.uniform(0.2, 0.6, 3).astype(np.float32)
    return lo, hi, jlo, jhi


def _f(x, j):
    return np.sin(2.0 * x) * np.exp(0.5 * j) + x * j


def test_pw2_fit_and_eval_match_jax():
    """The tensor-product fit of a smooth function on its sample grid and
    its evaluation at random points (inside and outside the rectangle)
    equal the JAX package's to f32 rounding; the interpolant is within
    1e-5 of the function."""
    lo, hi, jlo, jhi = _grid()
    xn, jn = TP.pw2_nodes(*map(torch.tensor, (lo, hi, jlo, jhi)), PX, DX, PJ,
                          DJ)
    xj, jj = JP.pw2_nodes(*map(jnp.asarray, (lo, hi, jlo, jhi)), PX, DX, PJ,
                          DJ)
    np.testing.assert_array_equal(xn.numpy(), np.asarray(xj))
    np.testing.assert_array_equal(jn.numpy(), np.asarray(jj))
    vals = _f(xn.numpy()[:, :, None], jn.numpy()[:, None, :]).astype(
        np.float32)
    ct = TP.pw2_fit(torch.tensor(vals), PX, DX, PJ, DJ)
    with jax.default_matmul_precision("highest"):
        cj = np.asarray(JP.pw2_fit(jnp.asarray(vals), PX, DX, PJ, DJ))
    np.testing.assert_allclose(ct.numpy(), cj, atol=1e-6)
    rng = np.random.default_rng(1)
    x = rng.uniform(0.3, 2.6, 400).astype(np.float32)
    j = rng.uniform(-0.7, 0.7, 400).astype(np.float32)
    for i in range(3):
        got = TP.pw2_eval(ct[i], torch.tensor(x), torch.tensor(j),
                          *map(torch.tensor, (lo[i], hi[i], jlo[i], jhi[i])),
                          PX, DX, PJ, DJ).numpy()
        with jax.default_matmul_precision("highest"):
            want = np.asarray(JP.pw2_eval(jnp.asarray(cj[i]), x, j, lo[i],
                                          hi[i], jlo[i], jhi[i], PX, DX, PJ,
                                          DJ))
        np.testing.assert_allclose(got, want, atol=1e-6)
        xc, jc = np.clip(x, lo[i], hi[i]), np.clip(j, jlo[i], jhi[i])
        np.testing.assert_allclose(got, _f(xc, jc), atol=1e-5)


def test_pw2_eval_backward_is_the_one_hot_product():
    """The table's cotangent sums each path's basis weights into its piece
    pair's row: autograd through ``select_rows`` equals the explicit
    one-hot product, and x and j get the clamp's zero past the edges."""
    lo, hi, jlo, jhi = (torch.tensor(v[0]) for v in _grid())
    coef = torch.randn(PX * PJ, (DX + 1) * (DJ + 1),
                       generator=torch.Generator().manual_seed(0),
                       requires_grad=True)
    x = torch.linspace(0.2, 3.0, 300, requires_grad=True)
    j = torch.linspace(-0.8, 0.8, 300, requires_grad=True)
    out = TP.pw2_eval(coef, x, j, lo, hi, jlo, jhi, PX, DX, PJ, DJ)
    gc, gx, gj = torch.autograd.grad(out.sum(), (coef, x, j))
    # the same sum through a dense select
    kx, _ = TP._piece_of(x.detach(), lo, hi, PX)
    kj, _ = TP._piece_of(j.detach(), jlo, jhi, PJ)
    onehot = torch.nn.functional.one_hot((kx * PJ + kj).long(), PX * PJ).to(
        coef.dtype)
    dense = lambda c: TP._clenshaw(TP._clenshaw(
        (onehot @ c).reshape(-1, DX + 1, DJ + 1),
        TP._piece_of(j.detach(), jlo, jhi, PJ)[1][:, None]),
        TP._piece_of(x.detach(), lo, hi, PX)[1])
    (gd,) = torch.autograd.grad(dense(coef).sum(), coef)
    torch.testing.assert_close(gc, gd, rtol=1e-6, atol=1e-6)
    outside = (x.detach() < lo) | (x.detach() > hi)
    assert bool((gx[outside] == 0).all()) and bool(gx[~outside].abs().sum()
                                                   > 0)


def test_hoist_gamma_tables_equal_jax():
    js, ts, jparams = make_pair("global", comp=CHEB16, model=SPEED_MODEL,
                                hoist_gamma=True, **HOIST)
    key = jax.random.key(11)
    dw, j, kms = js._prenoise(key, 512)
    with jax.default_matmul_precision("highest"):
        want = js._hoist_tables(jparams, (dw, j, kms))
    got = ts._hoist_tables(port_params(jparams),
                           (torch.tensor(np.asarray(dw)),
                            torch.tensor(np.asarray(j))))
    assert sorted(got) == sorted(want) == sorted(
        ["lo", "hi", "cc", "pc", "zc", "gc", "jlo", "jhi"])
    assert tuple(got["gc"].shape) == (3, PX * PJ, (DX + 1) * (DJ + 1))
    for name, w in want.items():
        w = np.asarray(w)
        np.testing.assert_allclose(got[name].detach().numpy(), w, rtol=1e-6,
                                   atol=1e-6 * np.abs(w).max(), err_msg=name)


@pytest.mark.parametrize("scheme", ["global", "multistep2"])
def test_hoist_gamma_loss_matches_jax(scheme):
    js, ts, jparams = make_pair(scheme, comp=CHEB16, model=SPEED_MODEL,
                                hoist_gamma=True, **HOIST)
    assert_loss_and_grads_match(js, ts, jparams, batch=512)


def test_hoist_gamma_on_off_within_jax_bound():
    """The Γ tables change the loss by their interpolation error only
    (5e-4 relative, the JAX package's test), and a 1-net scheme builds
    none."""
    model = dataclasses.replace(torch_merton(**SPEED_MODEL), N=5)
    _, on, jparams = make_pair("global", comp=CHEB16, model=SPEED_MODEL,
                               hoist_gamma=True, **HOIST)
    on = dataclasses.replace(on, model=model)
    off = dataclasses.replace(on, hoist_gamma=False)
    p = port_params(jparams)
    gen = lambda: torch.Generator().manual_seed(4)
    l_on = float(on.build_loss(256)(p, gen()).detach())
    l_off = float(off.build_loss(256)(p, gen()).detach())
    assert np.isfinite(l_on) and l_on == pytest.approx(l_off, rel=5e-4)
    _, one_net, jp1 = make_pair("multistep1", comp=CHEB16, model=SPEED_MODEL,
                                hoist_gamma=True, **HOIST)
    noise = one_net._prenoise(gen(), 64)
    assert "gc" not in one_net._hoist_tables(port_params(jp1), noise)


def test_hoist_z_false_matches_jax():
    """The Z head evaluated in the loop: no Z table, JAX's loss."""
    js, ts, jparams = make_pair("global", comp=CHEB16, model=SPEED_MODEL,
                                hoist_z=False, **HOIST)
    noise = ts._prenoise(torch.Generator().manual_seed(0), 64)
    assert "zc" not in ts._hoist_tables(port_params(jparams), noise)
    assert_loss_and_grads_match(js, ts, jparams, batch=512)


def test_table_price_matches_jax_and_the_series():
    """The per-step curves equal JAX's (both float64 host builds), the cubic
    reads them as JAX does, and the table is within 1e-5 of the series
    price over the spots a rollout visits."""
    tm, jm = torch_merton(price_mode="table"), jax_merton(price_mode="table")
    np.testing.assert_array_equal(tm._host["price_table"],
                                  np.asarray(jm._price_table))
    x = np.linspace(0.3, 3.0, 2001).astype(np.float32)
    for i in (0, 17, 49):
        got = tm.price(i, torch.tensor(x)).numpy()
        want = np.asarray(jm.price(jnp.asarray(i), jnp.asarray(x)))
        np.testing.assert_allclose(got, want, atol=5e-6)
        series = torch_merton().price(i, torch.tensor(x)).numpy()
        np.testing.assert_allclose(got, series, atol=1e-5)
    steps = torch.arange(3)[:, None]
    rows = tm.price(steps, torch.tensor(np.tile(x[:50], (3, 1))))
    for i in range(3):
        torch.testing.assert_close(rows[i], tm.price(i, torch.tensor(x[:50])))


@pytest.mark.parametrize("price_mode", ["table", "series"])
def test_hoisted_price_not_collocated_matches_jax(price_mode):
    """``hoist=True`` with a price the model does not collocate: no price
    table, the model's own pricer in the loop, JAX's loss."""
    model = dict(SPEED_MODEL, price_mode=price_mode)
    js, ts, jparams = make_pair("global", comp=CHEB16, model=model, **HOIST)
    noise = ts._prenoise(torch.Generator().manual_seed(0), 64)
    assert "pc" not in ts._hoist_tables(port_params(jparams), noise)
    assert_loss_and_grads_match(js, ts, jparams, batch=512)
