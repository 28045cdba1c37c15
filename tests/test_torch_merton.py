"""The port's Merton model equals the JAX package's: host tables, oracle
price, one SDE step on shared noise and the Chebyshev-collocated price; the
port's own samplers reproduce the jump law's moments."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepfbsdejsolvers_torch.models.merton import (
    make_merton_default as torch_merton)
from deepfbsdejsolvers_torch.solvers.train import make_generator
from deepfbsdejsolvers_tpu.models.merton import (
    make_merton_default as jax_merton)

N_SAMPLES = 400_000


def _pair(**kw):
    return torch_merton(**kw), jax_merton(**kw)


def test_series_and_icdf_tables_equal_jax():
    tm, jm = _pair(jump_sampler="icdf", price_mode="chebyshev")
    for name in ("tau", "r_bs", "sig_bs", "coeff"):
        np.testing.assert_array_equal(tm._host[name],
                                      np.asarray(getattr(jm, f"_{name}")))
    np.testing.assert_array_equal(tm._host["poisson_cdf"],
                                  np.asarray(jm._poisson_cdf))
    assert tm.dt == jm.dt


def test_price_at_origin_equals_jax_oracle():
    tm, jm = _pair()
    p = tm.price_at_origin()
    assert abs(p - jm.price_at_origin()) <= 1e-6
    assert abs(p - 0.271457) <= 1e-6


def test_step_matches_jax_on_shared_noise():
    tm, jm = _pair()
    rng = np.random.default_rng(1)
    b = 512
    x = rng.uniform(0.5, 2.0, b).astype(np.float32)
    dw = (math.sqrt(tm.dt) * rng.standard_normal(b)).astype(np.float32)
    j = (0.2 * rng.standard_normal(b) * (rng.uniform(size=b) < 0.1)
         ).astype(np.float32)
    y = rng.uniform(0.0, 1.0, b).astype(np.float32)
    for i in (0, 7, 49):
        got = tm.step(i, *map(torch.tensor, (x, dw, j, y)))
        want = jm.step(jnp.asarray(i), *map(jnp.asarray, (x, dw, j, y)))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


@pytest.mark.parametrize("batch", [256, 1000])
def test_chebyshev_price_matches_jax(batch):
    """At batch >= 4·n_cheb_price both packages collocate the exact series
    on the batch's range (and evaluate it directly below that).  The
    degree-63 Clenshaw sum rounds differently in the two frameworks, a few
    1e-7 absolute on prices of order 1: compared at 1e-6 absolute."""
    tm, jm = _pair(price_mode="chebyshev")
    x = np.random.default_rng(2).uniform(0.4, 2.5, batch).astype(np.float32)
    for i in (0, 25, 49):
        got = tm.price(i, torch.tensor(x)).numpy()
        want = np.asarray(jm.price(jnp.asarray(i), jnp.asarray(x)))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("sampler", ["exact", "icdf"])
def test_sampler_moments(sampler):
    """J = dN·μJ + σJ·sqrt(dN)·Z: E[J] = λdt·μJ, Var[J] = λdt(μJ² + σJ²),
    P(J = 0) = exp(−λdt)."""
    m = torch_merton(jump_sampler=sampler)
    j = m.sample_jumps(make_generator("cpu", 7, 0), (N_SAMPLES,)).numpy()
    lam_dt = 3.0 * m.dt
    assert abs(j.mean() - lam_dt * 0.0) < 4e-4
    assert abs(j.var() - lam_dt * 0.2**2) < 4e-4
    assert abs((j == 0).mean() - math.exp(-lam_dt)) < 2e-3
