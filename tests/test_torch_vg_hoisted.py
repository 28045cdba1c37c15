"""The pure-jump regime beyond the direct sweep, against the JAX package:
the hoisted tables of the global scheme (read by ``rollout_plain`` on the
Γ net's (t, X, X·J), with no Z table) and of one sumlocal scheme
(``shift_next``), with the piecewise and the Clenshaw evaluators, the
hoisted Monte-Carlo compensator through the rank-1 sweep, and the
evaluations ``y0_estimate``, ``warm_start_y0``, ``hoist_clamp_fractions``
and ``simulate_paths``.  The model is the VG speed configuration
(``price_eval="chebyshev"``, icdf jumps) cut to N = 4 steps, hidden (8, 8),
the noise JAX's.  Loss rel 1e-5 and grads rel 3e-5, as
tests/test_torch_schemes.py.

One case is held otherwise: the hoisted global scheme on piecewise tables.
There the Γ net is the only net, and its weights' gradient is the small
difference of two parts ~500 times larger, the realized Γ's and the
compensator table's (Γ − comp cancels b2 exactly and most of W2).  JAX's
f32 gradient sits 4.0e-5 from a float64 evaluation of the same loss, the
port's 2.6e-6, so the two lie 3.8e-5 apart.  That case holds the loss to
JAX, each of the two parts' gradients to JAX's, and the whole gradient to
the port's own float64 evaluation (ROADMAP Queue 3)."""

import dataclasses
import math

import jax
import numpy as np
import pytest
import torch

from deepfbsdejsolvers_torch.models.variance_gamma import (
    make_vg_default as torch_vg)
from deepfbsdejsolvers_torch.ops.compensator import CompensatorSpec
from deepfbsdejsolvers_torch.solvers.pricing import PricingSolver as TorchPS
from deepfbsdejsolvers_torch.solvers.train import make_generator
from deepfbsdejsolvers_tpu.models.variance_gamma import (
    make_vg_default as jax_vg)
from deepfbsdejsolvers_tpu.solvers.pricing import PricingSolver as JaxPS
from deepfbsdejsolvers_torch.nets.mlp import param_leaves
from deepfbsdejsolvers_torch.ops import chebyshev, piecewise
from deepfbsdejsolvers_torch.solvers import pricing as P
from test_torch_pricing import port_params, rel_norm
from test_torch_schemes import assert_loss_and_grads_match, jax_noise
from test_torch_vg_schemes import make_pair

N = 4
CHEB16 = dict(x_interp="chebyshev", n_cheb=16)
HOIST = dict(comp=CHEB16, hoist=True, sampler="icdf")


@pytest.fixture(scope="module")
def models():
    """Both packages' VG models of the speed configuration, cut to N
    steps, and the parity configuration's (exact jumps, direct price)."""
    speed = dict(price_eval="chebyshev")
    out = {}
    for key, kw in (((), {}), ((("jump_sampler", "icdf"),), speed)):
        out[key] = tuple(dataclasses.replace(f(**dict(key)), N=N, **kw)
                         for f in (torch_vg, jax_vg))
    return out


@pytest.mark.parametrize("scheme,interp", [("global", "clenshaw"),
                                           ("sumlocal2", "piecewise"),
                                           ("sumlocal2", "clenshaw")])
def test_hoisted_schemes_match_jax(models, scheme, interp):
    assert_loss_and_grads_match(
        *make_pair(models, scheme, hoist_interp=interp, **HOIST), batch=512)


def _float64_grads(monkeypatch, ts, params, noise):
    """The port's gradients of its loss evaluated in float64: the params,
    noise and fit and node tables cast up (the model's f32 tables promote
    where they meet them)."""
    for mod, name in ((piecewise, "_fit_on"), (piecewise, "_nodes_on")):
        f = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, f=f: f(*a).double())
    cheb = chebyshev._cheb_tables_on
    up = lambda n, dev: tuple(t.double() for t in cheb(n, dev))
    monkeypatch.setattr(chebyshev, "_cheb_tables_on", up)
    monkeypatch.setattr(P, "_cheb_tables_on", up)
    p64 = {k: {kk: ([t.detach().double().requires_grad_(True) for t in v]
                    if isinstance(v, list)
                    else v.detach().double().requires_grad_(True))
               for kk, v in d.items()} for k, d in params.items()}
    before = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        loss = ts.build_loss_from_noise(512)(
            p64, tuple(t.double() for t in noise))
        return [g.numpy() for g in torch.autograd.grad(loss,
                                                       param_leaves(p64))]
    finally:
        torch.set_default_dtype(before)


def test_hoisted_global_piecewise_matches_jax(models, monkeypatch):
    """The loss at rel 1e-5; the gradient of the rollout with JAX's tables
    held fixed and the gradient of the table build under one cotangent,
    each at rel 3e-5 of JAX's; the whole gradient at rel 3e-5 of the port's
    float64 evaluation (module docstring)."""
    js, ts, jparams = make_pair(models, "global", hoist_interp="piecewise",
                                **HOIST)
    key, batch = jax.random.key(11), 512
    noise = jax_noise(js, key, batch)
    jnoise = js._prenoise(key, batch)
    with jax.default_matmul_precision("highest"):
        lj = js.build_loss(batch)(jparams, key)
        want = js._hoist_tables(jparams, jnoise)
    p = port_params(jparams)
    lt = ts.build_loss_from_noise(batch)(p, noise)
    assert float(lt.detach()) == pytest.approx(float(lj), rel=1e-5)

    # the rollout, the tables fixed at JAX's
    tabs = {k: jax.numpy.asarray(v) for k, v in want.items()}

    def jax_roll(params):
        object.__setattr__(js, "_hoist_tables", lambda *a: tabs)
        try:
            with jax.default_matmul_precision("highest"):
                return js.build_loss(batch)(params, key)
        finally:
            object.__delattr__(js, "_hoist_tables")

    gj = jax.tree_util.tree_leaves(jax.grad(jax_roll)(jparams))
    fixed = {k: torch.tensor(np.asarray(v)) for k, v in want.items()}
    object.__setattr__(ts, "_hoist_tables", lambda *a, **k: fixed)
    try:
        roll = ts.build_loss_from_noise(batch)(p, noise)
    finally:
        object.__delattr__(ts, "_hoist_tables")
    gt = torch.autograd.grad(roll, param_leaves(p))
    assert rel_norm([g.numpy() for g in gt], [np.asarray(g) for g in gj]) \
        < 3e-5

    # the table build under a seeded cotangent on its compensator table
    cot = np.random.default_rng(0).standard_normal(
        want["cc"].shape).astype(np.float32)

    def jax_tables(params):
        with jax.default_matmul_precision("highest"):
            return jax.numpy.sum(js._hoist_tables(params, jnoise)["cc"]
                                 * cot)

    gj = jax.tree_util.tree_leaves(jax.grad(jax_tables)(jparams))
    built = (ts._hoist_tables(p, noise)["cc"] * torch.tensor(cot)).sum()
    gt = torch.autograd.grad(built, param_leaves(p), allow_unused=True)
    pairs = [(g.numpy(), np.asarray(w)) for g, w in zip(gt, gj)
             if g is not None]                      # y0 builds no table
    assert len(pairs) == 6
    assert rel_norm(*zip(*pairs)) < 3e-5

    # the whole gradient against the port's float64 evaluation
    g32 = torch.autograd.grad(lt, param_leaves(p))
    g64 = _float64_grads(monkeypatch, ts, p, noise)
    assert rel_norm([g.numpy() for g in g32], g64) < 3e-5


@pytest.mark.parametrize("scheme,shift_next", [("global", False),
                                               ("sumlocal2", True)])
def test_hoisted_tables_equal_jax(models, scheme, shift_next):
    """No Z table in the pure-jump regime; under ``shift_next`` no price
    table either."""
    js, ts, jparams = make_pair(models, scheme, hoist_interp="piecewise",
                                **HOIST)
    key = jax.random.key(11)
    noise = js._prenoise(key, 512, rows=N + shift_next)
    with jax.default_matmul_precision("highest"):
        want = js._hoist_tables(jparams, noise, shift_next)
    got = ts._hoist_tables(port_params(jparams), jax_noise(js, key, 512),
                           shift_next)
    assert sorted(got) == sorted(want) == sorted(
        ["lo", "hi", "cc"] + ([] if shift_next else ["pc"]))
    for name, w in want.items():
        w = np.asarray(w)
        np.testing.assert_allclose(got[name].detach().numpy(), w, rtol=1e-6,
                                   atol=2e-6 * np.abs(w).max(), err_msg=name)


def test_hoisted_monte_carlo_rank1_sweep_matches_jax(models):
    """The tables' compensator over each step's 64 draws, swept at the
    collocation points in the rank-1 form (x_prop), as JAX's Pallas
    sweep builds them."""
    assert_loss_and_grads_match(*make_pair(
        models, "global", comp=dict(kind="mc", n_mc=64, **CHEB16),
        hoist=True, hoist_interp="piecewise", sampler="icdf",
        sweep_impl="pallas"), batch=512)


def test_fused_rollout_refuses_the_vg_model(models):
    """The fused rollout kernels bake in the Merton form, σ·dW included;
    the VG model has none, so the port refuses where the JAX package warns
    and falls back to its scan."""
    tm = models[(("jump_sampler", "icdf"),)][0]
    with pytest.raises(ValueError, match="Merton form"):
        TorchPS(tm, "global", hidden=(8, 8),
                compensator=CompensatorSpec(**CHEB16), hoist=True,
                hoist_interp="piecewise", fused_rollout=True, device="cpu")


@pytest.mark.parametrize("scheme", ["global", "multistep1", "sumlocal_reg"])
def test_y0_estimate_equals_jax(models, scheme):
    js, ts, jparams = make_pair(models, scheme)
    got = ts.y0_estimate(port_params(jparams)).detach()
    assert got.shape == ()
    assert float(got) == pytest.approx(float(js.y0_estimate(jparams)),
                                       rel=1e-6, abs=1e-7)


def _payoff_sd(model, samples=10**6, seed=0):
    """Standard deviation of the discounted payoff e^{-rT}(X_T − K)⁺ under
    the uncoupled dynamics, drawn exactly in numpy: log X_T = log x0 +
    (r − ω)T + θG_T + σJ√G_T·Z, G_T ~ Gamma(T/κ, scale κ)."""
    rng = np.random.default_rng(seed)
    g = rng.gamma(model.T / model.kappa, model.kappa, samples)
    log_x = (math.log(model.x0) + (model.r - model.correction) * model.T
             + model.theta * g + model.sigJ * np.sqrt(g)
             * rng.standard_normal(samples))
    pay = math.exp(-model.r * model.T) * np.maximum(np.exp(log_x) - model.K,
                                                   0.0)
    return pay.std()


def test_warm_start_estimates_the_price():
    """Y0 of the Γ net warm-started at the uncoupled discounted payoff:
    within 4 standard errors of the FFT price at aLin = 0, and of the JAX
    package's own estimate (its draws are threefry's)."""
    tm, jm = torch_vg(a_lin=0.0), jax_vg(a_lin=0.0)
    ts = TorchPS(tm, "global", hidden=(8, 8), device="cpu")
    params = ts.init_params(make_generator("cpu", 0))
    batch = 65536
    warm = ts.warm_start_y0(params, make_generator("cpu", 9000), batch)
    assert "uz" not in warm and warm["gam"]["W"] is params["gam"]["W"]
    js = JaxPS(jm, "global", hidden=(8, 8))
    jwarm = js.warm_start_y0(js.init_params(jax.random.key(0)),
                             jax.random.key(9000), batch)
    se = _payoff_sd(tm) / math.sqrt(batch)
    got = float(warm["gam"]["y0"])
    assert abs(got - tm.price_at_origin()) < 4 * se
    assert abs(got - float(jwarm["gam"]["y0"])) < 4 * math.sqrt(2) * se
    other = TorchPS(tm, "sumlocal2", hidden=(8, 8), device="cpu")
    with pytest.raises(ValueError, match="no trainable y0"):
        other.warm_start_y0(other.init_params(make_generator("cpu", 0)),
                            make_generator("cpu", 1), 64)


@pytest.mark.parametrize("scheme", ["global", "sumlocal2"])
def test_clamp_fractions_and_paths_run(models, scheme):
    """The coupled forward stays inside the hoisted intervals on a fresh
    draw, and the global scheme simulates (N + 1, B) paths from Y0."""
    _, ts, jparams = make_pair(models, scheme, hoist_interp="piecewise",
                               **HOIST)
    p = port_params(jparams)
    fr = ts.hoist_clamp_fractions(p, make_generator("cpu", 2), 1024)
    assert fr.shape == (N,) and float(fr.max()) < 0.01
    if scheme == "global":
        xs, ys = ts.simulate_paths(p, make_generator("cpu", 3), 256)
        assert xs.shape == ys.shape == (N + 1, 256)
        assert torch.all(ys[0] == p["gam"]["y0"])
        assert bool(torch.isfinite(xs).all() and torch.isfinite(ys).all())
