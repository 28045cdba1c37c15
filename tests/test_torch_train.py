"""Training through the port: a few SGD steps from the same params on the
same noise stay with the JAX package's (SGD, not Adam: Adam's eps division
amplifies f32 noise), and the Adam facade trains to a finite, reproducible
Y0 history on the CPU."""

import dataclasses
import math

import jax
import optax
import pytest
import torch

from deepfbsdejsolvers_torch.models.merton import (
    make_merton_default as torch_merton)
from deepfbsdejsolvers_torch.nets.mlp import param_leaves
from deepfbsdejsolvers_torch.ops.compensator import CompensatorSpec
from deepfbsdejsolvers_torch.solvers.api import SolverGlobalFBSDE
from deepfbsdejsolvers_torch.solvers.train import make_generator
from test_torch_pricing import jax_noise, make_pair, port_params


def test_sgd_steps_match_jax():
    batch, lr = 1024, 1e-2
    js, ts, jparams = make_pair()
    key = jax.random.key(11)
    opt = optax.sgd(lr)
    with jax.default_matmul_precision("highest"):
        jloss = js.build_loss(batch)
        p, s = jparams, opt.init(jparams)
        for k in range(3):
            g = jax.jit(jax.grad(jloss))(p, jax.random.fold_in(key, k))
            up, s = opt.update(g, s, p)
            p = optax.apply_updates(p, up)
        lj = float(jax.jit(jloss)(p, jax.random.fold_in(key, 99)))

    tloss = ts.build_loss_from_noise(batch)
    tp = port_params(jparams)
    sgd = torch.optim.SGD(param_leaves(tp), lr=lr)
    for k in range(3):
        sgd.zero_grad()
        tloss(tp, jax_noise(js, jax.random.fold_in(key, k), batch)[2]
              ).backward()
        sgd.step()
    with torch.no_grad():
        lt = float(tloss(tp, jax_noise(js, jax.random.fold_in(key, 99),
                                       batch)[2]))
    assert lt == pytest.approx(lj, rel=1e-4)


@pytest.mark.parametrize("fused", [True, False])
def test_facade_trains_finite_and_reproducible(fused):
    model = dataclasses.replace(torch_merton(jump_sampler="icdf",
                                             price_mode="chebyshev"), N=4)

    def run():
        solver = SolverGlobalFBSDE(
            model, lrate=1e-2, hidden=(8, 8), seed=5,
            compensator=CompensatorSpec(x_interp="chebyshev", n_cheb=64),
            hoist=True, hoist_interp="piecewise", fused_rollout=fused,
            device="cpu")
        y0s, duration = solver.train(256, 512, 3, 2, verbose=False)
        return solver, y0s, duration

    solver, y0s, duration = run()
    assert len(y0s) == 2 and len(solver.lossList) == 2
    assert all(math.isfinite(v) for v in y0s + solver.lossList)
    assert duration > 0
    init = solver.core.init_params(make_generator("cpu", 5, 0))
    assert y0s[0] != float(init["uz"]["y0"]) and y0s[1] != y0s[0]
    assert run()[1] == y0s                     # same seed, same history
