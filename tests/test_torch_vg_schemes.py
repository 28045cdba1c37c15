"""The port's seven pricing schemes in the pure-jump regime equal the JAX
package's loss at fixed params and noise: loss rel 1e-5 and the gradients
of every parameter as one global norm rel 3e-5, the tolerances of
tests/test_torch_schemes.py.  The model is the Variance-Gamma parity
configuration (exact gamma jumps, the per-path FFT price) cut to N = 4
steps and hidden (8, 8), un-hoisted, with the compensator swept directly
over the 96-node gamma-subordinated quadrature at every path.  J comes from
JAX's ``_prenoise`` with its zero-width dW, and the Monte-Carlo node draws
of each row from ``sample_jumps(kms[i])``; both are handed to the port as
tensors.  The JAX side runs at full f32 matmul precision, and with
``sweep_impl="pallas"`` its Pallas sweep in interpret mode: on the Γ net's
feature X·J (a per-node ``a``) for global, multistep2 and sumlocal2, and on
the one-output U-net's (t, X + X·J) for multistep1 and sumlocal1.

JAX's un-chunked XLA sweep sums the Γ head's output-weight gradient over
the whole [96, 256] grid in one f32 contraction, which lands 3.4e-5 to
1.2e-4 from the port's for global, multistep1 and multistep2, where its
Pallas sweep and its chunked XLA sweep agree with the port (ROADMAP Queue
3 names this fault of the reference).  So the plain sweep runs chunked by
32 nodes on both sides, and the port's un-chunked plain sweep is held
against JAX's Pallas sweep."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from deepfbsdejsolvers_torch.models.variance_gamma import (
    make_vg_default as torch_vg)
from deepfbsdejsolvers_torch.ops import sweep as S
from deepfbsdejsolvers_torch.ops.compensator import (
    CompensatorSpec as TorchComp)
from deepfbsdejsolvers_torch.solvers.api import SOLVER_CLASSES
from deepfbsdejsolvers_torch.solvers.pricing import PRICING_SCHEMES
from deepfbsdejsolvers_torch.solvers.pricing import PricingSolver as TorchPS
from deepfbsdejsolvers_tpu.models.variance_gamma import (
    make_vg_default as jax_vg)
from deepfbsdejsolvers_tpu.ops.compensator import CompensatorSpec as JaxComp
from deepfbsdejsolvers_tpu.solvers.pricing import PricingSolver as JaxPS
from test_torch_pricing import port_params
from test_torch_schemes import assert_loss_and_grads_match

N, BATCH = 4, 256


@pytest.fixture(scope="module")
def models():
    """The FFT models of both packages cut to N steps, built once: each
    builds its 2^15-point tables on the host."""
    return {kw: (dataclasses.replace(torch_vg(**dict(kw)), N=N),
                 dataclasses.replace(jax_vg(**dict(kw)), N=N))
            for kw in ((), (("jump_sampler", "icdf"),))}


def make_pair(models, scheme, comp=None, sampler="exact", jax_sweep=None,
              **kw):
    """(JAX solver, port solver on the CPU, JAX params) of ``scheme`` on
    the VG model; ``comp`` holds the CompensatorSpec fields, and
    ``jax_sweep`` the JAX side's sweep_impl when it differs."""
    comp = comp or {}
    key = () if sampler == "exact" else (("jump_sampler", sampler),)
    tm, jm = models[key]
    kw = dict(kw, hidden=(8, 8))
    jkw = dict(kw, sweep_impl=jax_sweep) if jax_sweep else kw
    js = JaxPS(jm, scheme, compensator=JaxComp(**comp), **jkw)
    ts = TorchPS(tm, scheme, compensator=TorchComp(**comp), device="cpu",
                 **kw)
    return js, ts, js.init_params(jax.random.key(3))


@pytest.mark.parametrize("scheme", PRICING_SCHEMES)
def test_unhoisted_direct_sweep_matches_jax(models, scheme):
    assert_loss_and_grads_match(*make_pair(models, scheme,
                                           comp=dict(node_block=32)))


def test_unchunked_plain_sweep_matches_jax_pallas(models):
    assert_loss_and_grads_match(*make_pair(models, "global",
                                           jax_sweep="pallas"))


@pytest.mark.parametrize("scheme", ["global", "multistep1", "multistep2",
                                    "sumlocal1", "sumlocal2"])
def test_pallas_sweep_matches_jax(models, scheme):
    """The rank-1 sweep on the new input forms: a per-node a (the Γ net's
    X·J) and the two-feature U-net, against JAX's Pallas sweep."""
    assert_loss_and_grads_match(*make_pair(models, scheme,
                                           sweep_impl="pallas"))


@pytest.mark.parametrize("scheme,impl", [("global", "xla"),
                                         ("sumlocal1", "pallas")])
def test_monte_carlo_compensator_matches_jax(models, scheme, impl):
    """The compensator over 64 Monte-Carlo draws of the icdf sampler per
    step (JAX's draws, handed over), by the plain and the rank-1 sweep."""
    assert_loss_and_grads_match(*make_pair(
        models, scheme, comp=dict(kind="mc", n_mc=64), sampler="icdf",
        sweep_impl=impl))


def test_net_wiring_matches_jax(models):
    """No Z: every U-net has one output, pure-jump global has only the Γ
    net, which carries Y0."""
    for scheme in PRICING_SCHEMES:
        js, ts, _ = make_pair(models, scheme)
        want = {k: (s.n_in, s.hidden, s.n_out, s.with_y0)
                for k, s in js.net_specs().items()}
        got = {k: (s.n_in, s.hidden, s.n_out, s.with_y0)
               for k, s in ts.net_specs().items()}
        assert got == want, scheme
    assert set(want) == {"uz"} and want["uz"][2] == 1


def test_noise_is_pure_jump(models):
    """dW has zero width, on the CPU the rank-1 sweep is the plain version,
    and noise of the jump-diffusion shape is refused."""
    _, ts, jparams = make_pair(models, "sumlocal1", sweep_impl="pallas")
    before = (S.b3_forward.launches, S.b4_backward.launches)
    gen = torch.Generator().manual_seed(0)
    noise = ts._prenoise(gen, 64, ts.noise_rows)
    assert [tuple(t.shape) for t in noise] == [(N + 1, 0), (N + 1, 64)]
    loss = ts.build_loss(64)(port_params(jparams), gen)
    loss.backward()
    assert np.isfinite(float(loss.detach()))
    assert (S.b3_forward.launches, S.b4_backward.launches) == before
    with pytest.raises(ValueError, match="noise must be"):
        ts.build_loss_from_noise(64)(port_params(jparams),
                                     (torch.zeros(N + 1, 64), noise[1]))


@pytest.fixture(scope="module")
def facade_models():
    """The VG model at 2 steps with each pricer, sampler and price
    evaluation."""
    base = dataclasses.replace(torch_vg(), N=2)
    return [base, dataclasses.replace(base, pricer="invfourier",
                                      jump_sampler="icdf"),
            dataclasses.replace(base, price_eval="chebyshev")]


@pytest.mark.parametrize("name", sorted(SOLVER_CLASSES))
def test_facades_accept_the_vg_model(name, facade_models):
    """Each facade trains the VG model a step on the CPU, for every pricer,
    sampler and price evaluation, and reads out a finite Y0."""
    for model in facade_models:
        trainer = SOLVER_CLASSES[name](model, 1e-3, hidden=(8, 8),
                                       device="cpu")
        y0s, _ = trainer.train(256, 256, 1, 1, verbose=False)
        assert np.isfinite(y0s[-1]), (name, model)
