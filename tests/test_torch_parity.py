"""The port's un-hoisted global loss (the reference-faithful parity path)
equals the JAX package's ``build_loss`` at fixed params and noise: loss rel
1e-5 and the gradients of every parameter as one global norm rel 3e-5, the
tolerances of tests/test_torch_pricing.py.  The models are the parity
configuration's (exact Poisson jumps, the per-path series price) cut to
N = 3 steps and hidden (8, 8).  dW and J come from JAX's ``_prenoise``, and
the Monte-Carlo node draws of each step from ``sample_jumps(kms[i])``, as
the JAX loss draws them; both are handed to the port as tensors.  The JAX
side runs at full f32 matmul precision; with ``sweep_impl="pallas"`` it runs
its Pallas sweep in interpret mode, as on any machine without a TPU."""

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


def make_pair(a_lin=0.1, comp=None, model=None, jax_sweep=None, **kw):
    """(JAX solver, port solver on the CPU, JAX params) for one parity
    configuration; ``comp`` holds the CompensatorSpec fields, ``model``
    the keyword arguments of make_merton_default, ``jax_sweep`` the JAX
    side's sweep_impl when it differs from the port's."""
    comp, model = comp or {}, dict(model or {}, a_lin=a_lin)
    jm = dataclasses.replace(jax_merton(**model), N=N)
    tm = dataclasses.replace(torch_merton(**model), N=N)
    kw = dict(kw, hidden=(8, 8))
    jkw = dict(kw, sweep_impl=jax_sweep or kw.get("sweep_impl", "xla"))
    js = JaxPS(jm, "global", compensator=JaxComp(**comp), **jkw)
    ts = TorchPS(tm, "global", compensator=TorchComp(**comp), device="cpu",
                 **kw)
    return js, ts, js.init_params(jax.random.key(3))


def jax_noise(js, key, batch):
    """The JAX loss's noise as tensors: (dw, j) and, for the Monte-Carlo
    compensator, the (N, n_mc) node draws of every step."""
    dw, j, kms = js._prenoise(key, batch)
    noise = [torch.tensor(np.asarray(dw)), torch.tensor(np.asarray(j))]
    if js.compensator.kind == "mc":
        draws = [js.model.sample_jumps(kms[i], (js.compensator.n_mc,))
                 for i in range(N)]
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
    # both heads receive gradient: Γ through the sweep, UZ through Z and y0
    n_gam = len(param_leaves(p["gam"]))
    for grads in (gt[:n_gam], gt[n_gam:]):
        assert sum(float(g.abs().sum()) for g in grads) > 0


@pytest.mark.parametrize("a_lin,comp,sweep_impl,jax_sweep", [
    (0.1, {}, "pallas", None),                        # the parity config
    (0.0, {}, "pallas", None),                        # uncoupled
    (0.1, dict(kind="mc", n_mc=N_MC), "pallas", None),  # reference-exact MC
    # The port's plain MLP sweep, against the same loss through JAX's Pallas
    # sweep: JAX's own un-chunked XLA sweep sums the whole [M, B] grid at
    # once, and its gradient of the Γ head's output weights (a near
    # cancellation of Γ against its compensator) lies further from a
    # float64 evaluation of this loss than the f32 tolerance, where its
    # Pallas sweep and the port do not.  Chunked, below, the XLA sweep sums
    # per block and agrees.
    (0.1, {}, "xla", "pallas"),
    (0.1, dict(node_block=16), "xla", None),          # node-block chunking
    (0.1, dict(kind="mc", n_mc=N_MC, node_block=20), "xla", None),  # ragged
    (0.1, dict(x_interp="chebyshev", n_cheb=16), "xla", None),
    (0.1, dict(x_interp="chebyshev", n_cheb=16, cheb_robust_sigmas=2.0),
     "xla", None),
])
def test_unhoisted_loss_and_grads_match_jax(a_lin, comp, sweep_impl,
                                            jax_sweep):
    js, ts, jparams = make_pair(a_lin, comp, sweep_impl=sweep_impl,
                                jax_sweep=jax_sweep)
    assert_loss_and_grads_match(js, ts, jparams)


@pytest.mark.parametrize("sweep_impl", ["xla", "pallas"])
def test_hoisted_mc_tables_match_jax(sweep_impl):
    """The hoisted table build over each step's Monte-Carlo draws, on the
    speed configuration's model (icdf sampler, collocated price)."""
    comp = dict(kind="mc", n_mc=N_MC, x_interp="chebyshev", n_cheb=16)
    js, ts, jparams = make_pair(
        comp=comp, model=dict(jump_sampler="icdf", price_mode="chebyshev"),
        sweep_impl=sweep_impl, hoist=True, hoist_interp="piecewise")
    assert_loss_and_grads_match(js, ts, jparams, batch=512)


def test_cpu_parity_path_launches_no_kernel():
    """On the CPU the solver's sweep is the plain version: nothing is built
    or launched, and the noise carries the MC draws."""
    _, ts, jparams = make_pair(comp=dict(kind="mc", n_mc=N_MC),
                               sweep_impl="pallas")
    before = (S.b3_forward.launches, S.b4_backward.launches)
    gen = torch.Generator().manual_seed(0)
    noise = ts._prenoise(gen, 64)
    assert [tuple(t.shape) for t in noise] == [(N, 64), (N, 64), (N, N_MC)]
    loss = ts.build_loss(64)(port_params(jparams), gen)
    loss.backward()
    assert np.isfinite(float(loss.detach()))
    assert (S.b3_forward.launches, S.b4_backward.launches) == before
    with pytest.raises(ValueError, match="mc_nodes"):
        ts.build_loss_from_noise(64)(port_params(jparams), noise[:2])
