"""The six other schemes against the JAX package beyond the direct sweep: the
hoisted tables (piecewise and Clenshaw, the sumlocal schemes' on the
x_{i+1} marginals), the Chebyshev compensator of the ``merton_cheb`` gate,
the Monte-Carlo compensator, and the evaluations ``y0_estimate``,
``hoist_clamp_fractions`` and ``simulate_paths``, at shared params and
noise (N = 3, hidden (8, 8)).  Loss rel 1e-5 and grads rel 3e-5, as
tests/test_torch_schemes.py."""

import jax
import numpy as np
import pytest
import torch

from test_torch_pricing import port_params
from test_torch_schemes import (
    N_MC, assert_loss_and_grads_match, jax_noise, make_pair)

CHEB16 = dict(x_interp="chebyshev", n_cheb=16)
SPEED_MODEL = dict(jump_sampler="icdf", price_mode="chebyshev")


@pytest.mark.parametrize("scheme", ["multistep1", "sumlocal2"])
@pytest.mark.parametrize("interp", ["piecewise", "clenshaw"])
def test_hoisted_tables_match_jax(scheme, interp):
    js, ts, jparams = make_pair(scheme, comp=CHEB16, model=SPEED_MODEL,
                                hoist=True, hoist_interp=interp)
    assert_loss_and_grads_match(js, ts, jparams, batch=512)


@pytest.mark.parametrize("shift_next", [False, True])
def test_hoisted_tables_equal_jax(shift_next):
    """The tables themselves; under ``shift_next`` they span x_{i+1} and
    hold no price table, and only the global scheme has a Z table."""
    js, ts, jparams = make_pair("sumlocal2", comp=CHEB16, model=SPEED_MODEL,
                                hoist=True, hoist_interp="piecewise")
    key = jax.random.key(11)
    dw, j, kms = js._prenoise(key, 512, rows=4)
    with jax.default_matmul_precision("highest"):
        want = js._hoist_tables(jparams, (dw, j, kms), shift_next)
    got = ts._hoist_tables(port_params(jparams), jax_noise(js, key, 512),
                           shift_next)
    assert sorted(got) == sorted(want) == sorted(
        ["lo", "hi", "cc"] + ([] if shift_next else ["pc"]))
    for name, w in want.items():
        w = np.asarray(w)
        np.testing.assert_allclose(got[name].detach().numpy(), w, rtol=1e-6,
                                   atol=1e-6 * np.abs(w).max(), err_msg=name)


def test_chebyshev_compensator_of_the_cheb_gate_matches_jax():
    """``merton_cheb``: multistep1, icdf jumps, the sweep at 64 Chebyshev
    points, un-hoisted."""
    js, ts, jparams = make_pair("multistep1",
                                comp=dict(x_interp="chebyshev", n_cheb=64),
                                model=dict(jump_sampler="icdf"))
    assert_loss_and_grads_match(js, ts, jparams)


@pytest.mark.parametrize("scheme,kw", [
    ("multistep1", {}),
    ("sumlocal2", dict(sweep_impl="pallas")),
    ("sumlocal1", dict(comp=dict(kind="mc", n_mc=N_MC, **CHEB16),
                       model=SPEED_MODEL, hoist=True,
                       hoist_interp="piecewise")),
])
def test_monte_carlo_compensator_matches_jax(scheme, kw):
    """Each row's node draws: per step in the body, in the sumlocal
    schemes' pre-loop heads (row N), and in the hoisted tables."""
    kw = dict(kw)
    comp = kw.pop("comp", dict(kind="mc", n_mc=N_MC))
    js, ts, jparams = make_pair(scheme, comp=comp, **kw)
    assert_loss_and_grads_match(js, ts, jparams, batch=512)


@pytest.mark.parametrize("scheme", ["multistep1", "sumlocal_reg", "global"])
def test_y0_estimate_equals_jax(scheme):
    js, ts, jparams = make_pair(scheme)
    got = ts.y0_estimate(port_params(jparams)).detach()
    assert got.shape == ()
    assert float(got) == pytest.approx(float(js.y0_estimate(jparams)),
                                       rel=1e-6)


@pytest.mark.parametrize("scheme,a_lin", [
    ("global", 0.1), ("multistep1", 2.0), ("sumlocal2", 2.0),
    ("sumlocal_reg", 0.1)])
def test_hoist_clamp_fractions_equal_jax(scheme, a_lin):
    """Without interval padding some coupled paths leave the global and
    multistep intervals, and the port counts the same ones."""
    js, ts, jparams = make_pair(scheme, a_lin=a_lin, comp=CHEB16,
                                model=SPEED_MODEL, hoist=True,
                                hoist_interp="piecewise", hoist_pad_frac=0.0)
    key = jax.random.key(5)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(js.hoist_clamp_fractions(jparams, key, batch=512))
    got = ts.clamp_fractions_from_noise(port_params(jparams),
                                        jax_noise(js, key, 512))
    np.testing.assert_array_equal(got.numpy(), want)
    if scheme in ("global", "multistep1"):
        assert want.max() > 0
    fresh = ts.hoist_clamp_fractions(port_params(jparams),
                                     torch.Generator().manual_seed(0), 256)
    assert fresh.shape == (3,) and bool(((fresh >= 0) & (fresh <= 1)).all())


def test_simulated_paths_equal_jax():
    """The global scheme's trajectories under the policy, un-hoisted, on
    the noise JAX's ``simulate_paths`` draws; only the global scheme has
    them."""
    js, ts, jparams = make_pair("global")
    key = jax.random.key(9)
    with jax.default_matmul_precision("highest"):
        want = [np.asarray(a) for a in js.simulate_paths(jparams, key, 256)]
    with torch.no_grad():
        got = ts._rollout_direct(port_params(jparams),
                                 jax_noise(js, key, 256), trace=True)
    for g, w in zip(got, want):
        assert g.shape == w.shape == (4, 256)
        np.testing.assert_allclose(g.numpy(), w, rtol=2e-5, atol=2e-6)
    xs, ys = ts.simulate_paths(port_params(jparams),
                               torch.Generator().manual_seed(0), 64)
    assert xs.shape == ys.shape == (4, 64) and not xs.requires_grad
    assert bool((xs[0] == 1.0).all()) and bool(torch.isfinite(ys).all())
    _, ms, mparams = make_pair("multistep2")
    with pytest.raises(ValueError, match="global scheme"):
        ms.simulate_paths(port_params(mparams),
                          torch.Generator().manual_seed(0), 64)


def test_clamp_fractions_need_the_hoisted_tables():
    _, ts, jparams = make_pair("multistep1")
    with pytest.raises(ValueError, match="hoist=True"):
        ts.hoist_clamp_fractions(port_params(jparams),
                                 torch.Generator().manual_seed(0), 64)
