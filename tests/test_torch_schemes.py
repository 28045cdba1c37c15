"""The port's six other pricing schemes equal the JAX package's loss at fixed
params and noise: loss rel 1e-5 and the gradients of every parameter as one
global norm rel 3e-5, the tolerances of tests/test_torch_parity.py.  The
models are the parity configuration's (exact Poisson jumps, the per-path
series price) cut to N = 3 steps and hidden (8, 8), un-hoisted, with the
compensator swept directly over the quadrature at every path.  dW and J
come from JAX's ``_prenoise`` (N + 1 rows for the sumlocal schemes, whose
last row feeds the heads before the loop), and the Monte-Carlo node draws
of each row from ``sample_jumps(kms[i])``, as the JAX loss draws them; both
are handed to the port as tensors.  The JAX side runs at full f32 matmul
precision; with ``sweep_impl="pallas"`` it runs its Pallas sweep in
interpret mode, as on any machine without a TPU."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepfbsdejsolvers_torch.models.merton import (
    make_merton_default as torch_merton)
from deepfbsdejsolvers_torch.nets.mlp import param_leaves
from deepfbsdejsolvers_torch.ops import sweep as S
from deepfbsdejsolvers_torch.ops.compensator import (
    CompensatorSpec as TorchComp)
from deepfbsdejsolvers_torch.solvers.pricing import PricingSolver as TorchPS
from deepfbsdejsolvers_tpu.models.merton import (
    make_merton_default as jax_merton)
from deepfbsdejsolvers_tpu.ops.compensator import CompensatorSpec as JaxComp
from deepfbsdejsolvers_tpu.solvers.pricing import PricingSolver as JaxPS
from test_torch_pricing import port_params, rel_norm

N, BATCH, N_MC = 3, 256, 64
SCHEMES = ("multistep1", "multistep2", "sumlocal1", "sumlocal2",
           "sumlocal_reg", "multistep_reg")


def make_pair(scheme, a_lin=0.1, comp=None, model=None, **kw):
    """(JAX solver, port solver on the CPU, JAX params) of ``scheme`` in
    one configuration; ``comp`` holds the CompensatorSpec fields, ``model``
    the keyword arguments of make_merton_default."""
    comp, model = comp or {}, dict(model or {}, a_lin=a_lin)
    jm = dataclasses.replace(jax_merton(**model), N=N)
    tm = dataclasses.replace(torch_merton(**model), N=N)
    kw = dict(kw, hidden=(8, 8))
    js = JaxPS(jm, scheme, compensator=JaxComp(**comp), **kw)
    ts = TorchPS(tm, scheme, compensator=TorchComp(**comp), device="cpu",
                 **kw)
    return js, ts, js.init_params(jax.random.key(3))


def jax_noise(js, key, batch):
    """The JAX loss's noise as tensors: (dw, j) of N rows, or N + 1 for the
    sumlocal schemes, and for the Monte-Carlo compensator the node draws of
    every row."""
    n = js.model.N
    rows = n + 1 if js.scheme.startswith("sumlocal") else n
    dw, j, kms = js._prenoise(key, batch, rows=rows)
    noise = [torch.tensor(np.asarray(dw)), torch.tensor(np.asarray(j))]
    if js.compensator.kind == "mc":
        draws = [js.model.sample_jumps(kms[i], (js.compensator.n_mc,))
                 for i in range(rows)]
        noise.append(torch.tensor(np.asarray(jnp.stack(draws))))
    return tuple(noise)


def assert_loss_and_grads_match(js, ts, jparams, batch=BATCH):
    key = jax.random.key(11)
    with jax.default_matmul_precision("highest"):
        lj, gj = jax.jit(jax.value_and_grad(js.build_loss(batch)))(jparams,
                                                                   key)
    p = port_params(jparams)
    lt = ts.build_loss_from_noise(batch)(p, jax_noise(js, key, batch))
    gt = torch.autograd.grad(lt, param_leaves(p))
    assert float(lt.detach()) == pytest.approx(float(lj), rel=1e-5)
    rel = rel_norm([g.numpy() for g in gt],
                   [np.asarray(g) for g in jax.tree_util.tree_leaves(gj)])
    assert rel < 3e-5, rel
    # every net receives gradient (the Γ net through Γ and its sweep)
    for name in p:
        assert sum(float(g.abs().sum()) for g, t in zip(gt, param_leaves(p))
                   if any(t is u for u in param_leaves(p[name]))) > 0, name


@pytest.mark.parametrize("scheme", SCHEMES)
def test_unhoisted_direct_sweep_matches_jax(scheme):
    js, ts, jparams = make_pair(scheme)
    assert_loss_and_grads_match(js, ts, jparams)


@pytest.mark.parametrize("scheme", ["multistep2", "sumlocal2"])
def test_pallas_sweep_on_the_exp_feature_matches_jax(scheme):
    """The rank-1 sweep of the Γ net on f = e^J, against JAX's Pallas sweep
    in interpret mode."""
    js, ts, jparams = make_pair(scheme, sweep_impl="pallas")
    assert_loss_and_grads_match(js, ts, jparams)


def test_net_wiring_matches_jax():
    for scheme in SCHEMES + ("global",):
        js, ts, _ = make_pair(scheme)
        want = {k: (s.n_in, s.hidden, s.n_out, s.with_y0)
                for k, s in js.net_specs().items()}
        got = {k: (s.n_in, s.hidden, s.n_out, s.with_y0)
               for k, s in ts.net_specs().items()}
        assert got == want, scheme


@pytest.mark.parametrize("scheme", ["multistep1", "sumlocal1"])
def test_pallas_sweep_of_the_unet_raises(scheme):
    """multistep1/sumlocal1 sweep the 2-output U-net, which B3/B4 do not
    take: the port refuses at construction, where the JAX package warns and
    falls back to its XLA sweep."""
    with pytest.raises(ValueError, match="2-output U-net"):
        TorchPS(dataclasses.replace(torch_merton(), N=N), scheme,
                hidden=(8, 8), sweep_impl="pallas", device="cpu")
    with pytest.raises(ValueError, match="2-output U-net"):
        TorchPS(dataclasses.replace(torch_merton(), N=N), scheme,
                hidden=(8, 8), sweep_impl="pallas", device="cuda")


def test_cpu_sumlocal2_draws_n_plus_one_rows_and_launches_no_kernel():
    """The sumlocal noise has N + 1 rows, MC draws included, and on the CPU
    the rank-1 sweep is the plain version."""
    _, ts, jparams = make_pair("sumlocal2", comp=dict(kind="mc", n_mc=N_MC),
                               sweep_impl="pallas")
    before = (S.b3_forward.launches, S.b4_backward.launches)
    gen = torch.Generator().manual_seed(0)
    noise = ts._prenoise(gen, 64, ts.noise_rows)
    assert [tuple(t.shape) for t in noise] == [(N + 1, 64)] * 2 + [
        (N + 1, N_MC)]
    loss = ts.build_loss(64)(port_params(jparams), gen)
    loss.backward()
    assert np.isfinite(float(loss.detach()))
    assert (S.b3_forward.launches, S.b4_backward.launches) == before
    with pytest.raises(ValueError, match="noise must be"):
        ts.build_loss_from_noise(64)(port_params(jparams),
                                     tuple(t[:N] for t in noise))
