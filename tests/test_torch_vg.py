"""The port's Variance-Gamma model (models/variance_gamma.py) and its ops
(ops/interp.py, the gamma-subordinated quadrature) against the JAX
package's: the host tables, the pricers, the forward step, the quadrature
and both interpolators, on inputs drawn with numpy from a seed.  The two
samplers are held to the VG increment law by their moments, as
tests/test_jumps.py and tests/test_fast_paths.py hold the JAX samplers:
torch's generators cannot reproduce JAX's draws."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepfbsdejsolvers_torch.models.variance_gamma import (
    make_vg_default as torch_vg)
from deepfbsdejsolvers_torch.ops import interp as TI
from deepfbsdejsolvers_torch.ops.compensator import (
    CompensatorSpec as TorchComp, gamma_subordinated_quadrature as torch_gq)
from deepfbsdejsolvers_tpu.models.variance_gamma import (
    make_vg_default as jax_vg)
from deepfbsdejsolvers_tpu.ops import interp as JI
from deepfbsdejsolvers_tpu.ops.compensator import (
    CompensatorSpec as JaxComp, gamma_subordinated_quadrature as jax_gq)

N = 8
# the Gil-Pelaez tables take ~1.5 s a step to build on the host, so the
# invfourier models are cut to 2 steps
N_INV = 2


def pair(n=N, **kw):
    """(port model, JAX model) of make_vg_default(**kw) cut to n steps."""
    return (dataclasses.replace(torch_vg(**kw), N=n),
            dataclasses.replace(jax_vg(**kw), N=n))


def spots(n=1000, seed=0):
    """Spots drawn lognormally around x0 = 1, float32."""
    rng = np.random.default_rng(seed)
    return np.exp(0.3 * rng.standard_normal(n)).astype(np.float32)


@pytest.fixture(scope="module")
def fft_pair():
    return pair()


@pytest.fixture(scope="module")
def inv_pair():
    return pair(N_INV, pricer="invfourier")


def test_fft_and_gil_pelaez_tables_equal_jax(fft_pair, inv_pair):
    tm, jm = fft_pair
    np.testing.assert_array_equal(tm._host["fft"], np.asarray(jm._fft_table))
    assert tm._grid == (jm._ku0, jm._dku)
    tm, jm = inv_pair
    np.testing.assert_array_equal(tm._host["q1"], np.asarray(jm._q1_table))
    np.testing.assert_array_equal(tm._host["q2"], np.asarray(jm._q2_table))
    assert tm._grid == (jm._k0, jm._dk)
    assert tm.correction == jm.correction


def test_icdf_table_equals_jax():
    tm, jm = pair(jump_sampler="icdf")
    np.testing.assert_allclose(tm._host["g_coef"], np.asarray(jm._g_coef),
                               rtol=0, atol=1e-7)


@pytest.mark.parametrize("spec", [dict(), dict(n_laguerre=8, n_hermite=5)])
def test_gamma_subordinated_quadrature_equals_jax(spec):
    tm, jm = pair()
    got = tm.jump_quadrature(TorchComp(**spec))
    want = jm.jump_quadrature(JaxComp(**spec))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[0].shape == (spec.get("n_laguerre", 12)
                            * spec.get("n_hermite", 8),)
    args = (1.0 / 3.0, 0.1, -0.1, 0.2)
    for g, w in zip(torch_gq(*args, TorchComp()), jax_gq(*args, JaxComp())):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("kind", ["linear", "cubic"])
def test_interpolators_equal_jax(kind):
    """On one curve and on rows of a table, inside the grid and past both
    ends (the clamped edge cells): the same f32 arithmetic, bit for bit."""
    rng = np.random.default_rng(4)
    table = rng.standard_normal((5, 40)).astype(np.float32)
    x = rng.uniform(-1.0, 5.0, 300).astype(np.float32)
    x0, dx = -0.3, 0.1
    jf = getattr(JI, f"uniform_interp_{kind}")
    tf = getattr(TI, f"uniform_interp_{kind}")
    want = np.asarray(jf(jnp.asarray(table[2]), jnp.asarray(x), x0, dx))
    got = tf(torch.tensor(table[2]), torch.tensor(x), x0, dx).numpy()
    np.testing.assert_array_equal(got, want)
    rows = rng.integers(0, 5, 300)
    by_row = tf(torch.tensor(table), torch.tensor(x), x0, dx,
                row=torch.tensor(rows)).numpy()
    want_rows = np.stack([np.asarray(jf(jnp.asarray(table[r]),
                                        jnp.asarray(x[k:k + 1]), x0, dx))[0]
                          for k, r in enumerate(rows)])
    np.testing.assert_array_equal(by_row, want_rows)


def test_fft_price_equals_jax(fft_pair):
    """The FFT price agrees to the f32 resolution of its grid: the cell
    position (log(X/K) + 205.9)/0.0126 is rounded at ULP(205.9) = 1.5e-5
    in log-moneyness, so one ULP of difference between torch's and XLA's
    f32 log moves the price by up to X·1.5e-5.  Fed the same log-moneyness,
    the interpolation is bit-identical (test_interpolators_equal_jax)."""
    tm, jm = fft_pair
    x = spots()
    for i in (0, 3, N - 1):
        got = tm.price_fft(i, torch.tensor(x)).numpy()
        want = np.asarray(jm.price_fft(jnp.asarray(i), jnp.asarray(x)))
        assert np.all(np.abs(got - want) <= 2e-5 * x), i
    steps = np.arange(N)[:, None]
    grid = np.broadcast_to(x[:64], (N, 64))
    got = tm.price(torch.tensor(steps), torch.tensor(grid)).numpy()
    want = np.asarray(jax.vmap(jm.price)(jnp.arange(N), jnp.asarray(grid)))
    assert np.all(np.abs(got - want) <= 2e-5 * grid)


def test_invfourier_price_equals_jax(inv_pair):
    tm, jm = inv_pair
    x = spots()
    for i in range(N_INV):
        got = tm.price_invfourier(i, torch.tensor(x)).numpy()
        want = np.asarray(jm.price_invfourier(jnp.asarray(i),
                                              jnp.asarray(x)))
        np.testing.assert_allclose(got, want, rtol=1e-6,
                                   atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("pricer", ["fft", "invfourier"])
def test_chebyshev_price_equals_jax(pricer, fft_pair, inv_pair):
    """price_eval="chebyshev" collocates the direct price at 64 points of
    the batch's range: the collocated values carry the direct price's
    agreement (2e-5·X for the FFT curve, see above)."""
    tm, jm = fft_pair if pricer == "fft" else inv_pair
    tm = dataclasses.replace(tm, price_eval="chebyshev")
    jm = dataclasses.replace(jm, price_eval="chebyshev")
    x = spots(512, seed=1)
    tol = 2e-5 if pricer == "fft" else 1e-6
    for i in (0, tm.N - 1):
        got = tm.price(i, torch.tensor(x)).numpy()
        want = np.asarray(jm.price(jnp.asarray(i), jnp.asarray(x)))
        assert np.all(np.abs(got - want) <= tol * np.maximum(x, 1.0)), i


def test_price_at_origin_equals_jax(inv_pair):
    """A(0, x0) reads step 0, whose maturity is T whatever N: the
    invfourier pair cut to N_INV steps gives the default model's."""
    for tm, jm in ((torch_vg(), jax_vg()), inv_pair):
        assert tm.price_at_origin() == pytest.approx(jm.price_at_origin(),
                                                     rel=1e-6)
        assert tm.price_at_origin() == pytest.approx(0.133141, abs=2e-6)


def test_step_and_log_increments_equal_jax(fft_pair):
    tm, jm = fft_pair
    rng = np.random.default_rng(5)
    x = spots(300, seed=2)
    j = (0.05 * rng.standard_normal(300)).astype(np.float32)
    y = (0.13 + 0.02 * rng.standard_normal(300)).astype(np.float32)
    price = (0.1 + 0.01 * rng.standard_normal(300)).astype(np.float32)
    t = lambda a: torch.tensor(a)
    for i in (0, N - 1):
        got = tm.step(i, t(x), t(j), t(y)).numpy()
        want = np.asarray(jm.step(jnp.asarray(i), jnp.asarray(x),
                                  jnp.asarray(j), jnp.asarray(y)))
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
        got = tm.step(i, t(x), t(j), t(y), price=t(price)).numpy()
        want = np.asarray(jm.step(jnp.asarray(i), jnp.asarray(x),
                                  jnp.asarray(j), jnp.asarray(y),
                                  price=jnp.asarray(price)))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    got = tm.uncoupled_log_increments(torch.zeros(0), t(j)).numpy()
    want = np.asarray(jm.uncoupled_log_increments(jnp.zeros(0),
                                                  jnp.asarray(j)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("sampler", ["exact", "icdf"])
def test_samplers_draw_the_vg_law(sampler):
    """E[J] = θ·dt, Var J = (σJ² + θ²κ)·dt and E[e^J] = e^{ω·dt} at the
    default N = 30, each within 4 standard errors of 2^21 draws."""
    m = torch_vg(jump_sampler=sampler)
    n = 2**21
    gen = torch.Generator().manual_seed(11)
    j = m.sample_jumps(gen, (n,)).double()
    dt, kappa, theta, sig = m.dt, m.kappa, m.theta, m.sigJ
    var = (sig**2 + theta**2 * kappa) * dt
    assert abs(float(j.mean()) - theta * dt) < 4 * math.sqrt(var / n)
    se_var = math.sqrt(float(((j - j.mean())**2).var()) / n)
    assert abs(float(j.var()) - var) < 4 * se_var
    em = torch.expm1(j)
    se_e = math.sqrt(float(em.var()) / n)
    assert abs(float(em.mean()) - math.expm1(m.correction * dt)) < 4 * se_e
    g = m.sample_gamma(gen, (n,))
    assert float(g.min()) >= 0.0
    assert abs(float(g.double().mean()) - dt) < 4 * math.sqrt(kappa * dt / n)


def test_samplers_follow_the_generator_and_the_shape():
    m = torch_vg()
    a = m.sample_jumps(torch.Generator().manual_seed(3), (4, 5))
    b = m.sample_jumps(torch.Generator().manual_seed(3), (4, 5))
    assert a.shape == (4, 5) and a.dtype == torch.float32
    assert torch.equal(a, b)


def test_model_rejects_unknown_options():
    for kw in (dict(pricer="cos"), dict(price_eval="table"),
               dict(jump_sampler="rbg")):
        with pytest.raises(ValueError):
            dataclasses.replace(torch_vg(), **kw)
