"""Training the six other schemes: the cosine-decay schedule equals optax's,
Adam under it through the port's ``fit`` follows the JAX package's ``fit``
on the same noise, ``warm_start_y0`` estimates the Merton price, and every
facade builds and trains on the CPU."""

import dataclasses
import math

import jax
import numpy as np
import optax
import pytest
import torch

import deepfbsdejsolvers_tpu.solvers.api as jax_api
from deepfbsdejsolvers_torch.models.merton import (
    make_merton_default as torch_merton)
from deepfbsdejsolvers_torch.solvers import api
from deepfbsdejsolvers_torch.solvers.pricing import PricingSolver
from deepfbsdejsolvers_torch.solvers.train import (
    cosine_decay_schedule, fit, make_generator)
from deepfbsdejsolvers_tpu.solvers.train import fit as jax_fit
from test_torch_pricing import port_params, rel_norm
from test_torch_schemes import N, jax_noise, make_pair


@pytest.mark.parametrize("peak,steps", [(3e-3, 2400), (6e-3, 4800),
                                        (1e-2, 7)])
def test_cosine_schedule_equals_optax_at_every_step(peak, steps):
    """optax evaluates in f32: agreement to its rounding, an absolute
    2e-7·peak where the cosine nearly cancels 1."""
    ours = cosine_decay_schedule(peak, steps)
    theirs = optax.cosine_decay_schedule(peak, steps)
    counts = range(steps + 3)
    np.testing.assert_allclose([ours(k) for k in counts],
                               [float(theirs(k)) for k in counts],
                               rtol=1e-6, atol=2e-7 * peak)
    with pytest.raises(ValueError, match="positive"):
        cosine_decay_schedule(peak, 0)


def test_adam_under_the_schedule_follows_jax_fit():
    """Two outer epochs of three Adam steps under the cosine schedule from
    the same params, each step on the noise JAX's ``fit`` draws for it:
    the Y0 read-outs and the final params agree (rel 1e-4, the tolerance of
    tests/test_torch_train.py's SGD steps)."""
    batch, num_epoch, num_epoch_ext, steps = 256, 3, 2, 6
    js, ts, jparams = make_pair("multistep2")
    key = jax.random.key(7)
    sched = optax.cosine_decay_schedule(1e-2, steps)
    with jax.default_matmul_precision("highest"):
        want = jax_fit(js.build_loss(batch), jparams, key, sched, num_epoch,
                       num_epoch_ext, y0_fn=js.y0_estimate, verbose=False)
    keys = [k for e in range(num_epoch_ext) for k in jax.random.split(
        jax.random.fold_in(key, 2 * e), num_epoch)]
    from_noise = ts.build_loss_from_noise(batch)
    count = iter(range(steps))

    def loss_fn(params, generator):
        return from_noise(params, jax_noise(js, keys[next(count)], batch))

    got = fit(loss_fn, port_params(jparams), 0,
              cosine_decay_schedule(1e-2, steps), num_epoch, num_epoch_ext,
              y0_fn=ts.y0_estimate, verbose=False)
    np.testing.assert_allclose(got.y0_history, want.y0_history, rtol=1e-4)
    # The Γ net's output bias is left out: Γ − E_J[Γ] cancels it (the node
    # weights sum to 1), so the loss does not depend on it, its gradient is
    # rounding noise, and Adam normalizes that noise into a full step in
    # either package.
    def leaves(tree):
        gam_b2 = len(tree["gam"]["W"]) + len(tree["gam"]["b"]) - 1
        out = [np.asarray(t.detach() if torch.is_tensor(t) else t)
               for t in jax.tree_util.tree_leaves(
                   tree, is_leaf=torch.is_tensor)]
        return out[:gam_b2] + out[gam_b2 + 1:]

    rel = rel_norm(leaves(got.params), leaves(want.params))
    assert rel < 1e-4, rel
    assert rel_norm(leaves(got.params), leaves(jparams)) > 100 * rel


def _payoff_sd(model, samples=10**6, seed=0):
    """Standard deviation of the discounted payoff e^{-rT}(X_T − K)⁺ under
    the uncoupled dynamics, drawn exactly in numpy: log X_T = log x0 +
    N·drift + σ·W_T + the compound-Poisson sum over [0, T]."""
    rng = np.random.default_rng(seed)
    kbar = math.exp(model.muJ + 0.5 * model.sigJ**2) - 1.0
    drift = (model.r - 0.5 * model.sigma**2 - model.lam * kbar) * model.T
    k = rng.poisson(model.lam * model.T, samples)
    log_x = (math.log(model.x0) + drift
             + model.sigma * math.sqrt(model.T) * rng.standard_normal(samples)
             + k * model.muJ + model.sigJ * np.sqrt(k)
             * rng.standard_normal(samples))
    pay = math.exp(-model.r * model.T) * np.maximum(np.exp(log_x) - model.K,
                                                   0.0)
    return pay.std()


def test_warm_start_estimates_the_price():
    """At aLin = 0 the uncoupled discounted payoff is unbiased for the
    closed-form price: the estimate lands within 4 standard errors."""
    model = torch_merton(a_lin=0.0)
    solver = PricingSolver(model, "global", hidden=(8, 8), device="cpu")
    params = solver.init_params(make_generator("cpu", 0))
    batch = 65536
    warm = solver.warm_start_y0(params, make_generator("cpu", 9000), batch)
    se = _payoff_sd(model) / math.sqrt(batch)
    assert abs(float(warm["uz"]["y0"]) - model.price_at_origin()) < 4 * se
    assert warm["uz"]["y0"].shape == () and warm["gam"] is params["gam"]
    assert warm["uz"]["W"] is params["uz"]["W"]
    assert float(params["uz"]["y0"]) != float(warm["uz"]["y0"])


@pytest.mark.parametrize("scheme", ["multistep1", "sumlocal2",
                                    "multistep_reg"])
def test_warm_start_raises_without_a_y0(scheme):
    solver = PricingSolver(torch_merton(), scheme, hidden=(8, 8),
                           device="cpu")
    params = solver.init_params(make_generator("cpu", 0))
    with pytest.raises(ValueError, match="no trainable y0"):
        solver.warm_start_y0(params, make_generator("cpu", 1), 64)


def test_solver_classes_mirror_jax():
    assert list(api.SOLVER_CLASSES) == list(jax_api.SOLVER_CLASSES)
    for name, cls in api.SOLVER_CLASSES.items():
        assert cls.__name__ == jax_api.SOLVER_CLASSES[name].__name__
        assert cls.scheme == jax_api.SOLVER_CLASSES[name].scheme


@pytest.mark.parametrize("name", ["SumMultiStep1", "SumMultiStep2",
                                  "SumLocal1", "SumLocal2", "SumLocalReg",
                                  "SumMultiStepReg"])
def test_facade_trains_finite(name):
    model = dataclasses.replace(torch_merton(), N=N)
    solver = api.SOLVER_CLASSES[name](model, lrate=1e-2, hidden=(8, 8),
                                      seed=2, device="cpu")
    y0s, duration = solver.train(64, 128, 2, 2, verbose=False)
    assert len(y0s) == 2 and all(math.isfinite(v)
                                 for v in y0s + solver.lossList)
    assert y0s[1] != y0s[0] and duration > 0
