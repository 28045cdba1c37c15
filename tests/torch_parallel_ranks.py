"""Rank functions of the data-parallel tests (tests/test_torch_parallel*.py).

The ranks are spawned processes (``parallel/launch.py``), so what they run
lives here, in a module that imports torch and the port only: a rank that
imported a test file would import JAX too.  Each function runs on every
rank and returns plain values and numpy arrays; the test files compare
them with JAX's and with each other.
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import torch

from deepfbsdejsolvers_torch.models.merton import make_merton_default
from deepfbsdejsolvers_torch.models.mfg_smart_grid import make_mfg_default
from deepfbsdejsolvers_torch.models.variance_gamma import make_vg_default
from deepfbsdejsolvers_torch.nets.mlp import param_leaves
from deepfbsdejsolvers_torch.ops.compensator import CompensatorSpec
from deepfbsdejsolvers_torch.parallel.data_parallel import (
    all_reduce_grads, make_dp_epoch, make_dp_loss, make_dp_update,
    make_mesh)
from deepfbsdejsolvers_torch.solvers.mfg import MFGSolver
from deepfbsdejsolvers_torch.solvers.pricing import PricingSolver
from deepfbsdejsolvers_torch.solvers.train import (
    fit, fold_in, make_adam, make_generator)
from deepfbsdejsolvers_torch.utils.convert import params_from_jax

N, HIDDEN = 4, (8, 8)
# The configurations both packages build alike: (model, model keyword
# arguments, fields replaced on the model, CompensatorSpec fields, solver
# fields).  The quadrature's 13 nodes pad to 14 over two shards.
QUAD13 = dict(n_poisson_max=3, n_hermite=4)
SPEED = dict(jump_sampler="icdf", price_mode="chebyshev")
CONFIGS = {
    "merton_direct": ("merton", {}, {}, QUAD13, {}),
    "merton_hoisted": ("merton", SPEED, {},
                       dict(x_interp="chebyshev", n_cheb=64),
                       dict(hoist=True, hoist_interp="piecewise")),
    # the same through the hand-written adjoint (solvers/adjoint.py)
    "merton_adjoint": ("merton", SPEED, {},
                       dict(x_interp="chebyshev", n_cheb=64),
                       dict(hoist=True, hoist_interp="piecewise",
                            adjoint=True)),
    "merton_cheb": ("merton", SPEED, {}, dict(x_interp="chebyshev", n_cheb=8),
                    {}),
    "vg_speed": ("vg", dict(jump_sampler="icdf"),
                 dict(price_eval="chebyshev"),
                 dict(x_interp="chebyshev", n_cheb=16),
                 dict(hoist=True, hoist_interp="piecewise")),
}
WORLD = 4
# the SGD of the fit comparison (Adam's normalisation would amplify the
# reassociation noise of the mesh mean to whole steps)
SGD_LR = 1e-2


def make_model(name, factories):
    """The model of configuration ``name`` from one package's factories
    {"merton": ..., "vg": ...}, cut to N steps."""
    which, kw, fields, _, _ = CONFIGS[name]
    return dataclasses.replace(factories[which](**kw), N=N, **fields)


def torch_solver(name, comp=None, **kw) -> PricingSolver:
    _, _, _, comp0, solver = CONFIGS[name]
    model = make_model(name, {"merton": make_merton_default,
                              "vg": make_vg_default})
    return PricingSolver(model, "global", hidden=HIDDEN, device="cpu",
                         compensator=CompensatorSpec(**(comp or comp0)),
                         **dict(solver, **kw))


def tiny_mfg():
    """The N = 12 truncation of the 1-day MFG model."""
    m = make_mfg_default(nb_days=1)
    return dataclasses.replace(
        m, T=12.0 * m.dt, q_aver=np.asarray(m.q_aver, np.float64)[:13])


def digest(params) -> str:
    """A hash of the parameter leaves' bytes."""
    h = hashlib.sha256()
    for t in param_leaves(params):
        h.update(t.detach().contiguous().numpy().tobytes())
    return h.hexdigest()


def _grads(params):
    return [t.grad.detach().numpy().copy() for t in param_leaves(params)]


def _fresh(params):
    """A copy of the params tree with trainable leaves."""
    if isinstance(params, dict):
        return {k: _fresh(v) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [_fresh(v) for v in params]
    return params.detach().clone().requires_grad_(True)


def _mesh_value_and_grad(loss_fn, params, x, mesh):
    """This rank's loss at ``x``, its backward, and the mesh mean of both
    (``all_reduce_grads``): (mesh loss, gradient leaves)."""
    params = _fresh(params)
    loss = loss_fn(params, x)
    loss.backward()
    mean = all_reduce_grads(param_leaves(params), loss, mesh)
    return float(mean), _grads(params)


def _serial_value_and_grad(loss_fn, params, xs):
    """The mean of the losses at each of ``xs`` and its gradients, in this
    process."""
    params = _fresh(params)
    loss = torch.mean(torch.stack([loss_fn(params, x) for x in xs]))
    loss.backward()
    return float(loss), _grads(params)


class SerialMeshMean:
    """``loss(params, generator)``: the mean over ``n`` shards of
    ``loss_fn`` at ``fold_in(generator, i)``, in one process.  The shards'
    generators persist while ``generator`` does, so successive steps of an
    epoch draw on, as each data rank's generator does under a mesh."""

    def __init__(self, loss_fn, n):
        self.loss_fn, self.n, self.gen, self.shards = loss_fn, n, None, []

    def __call__(self, params, generator):
        if generator is not self.gen:
            self.gen = generator
            self.shards = [fold_in(generator, i) for i in range(self.n)]
        return torch.mean(torch.stack([self.loss_fn(params, g)
                                       for g in self.shards]))


def parallel_checks(rank: int, jax_cases: dict) -> dict:
    """Every check of tests/test_torch_parallel.py that needs ranks, on a
    world of four: against JAX (``jax_cases``: per configuration the JAX
    params, each rank's shard noise and the batch), then against serial
    evaluations in this process."""
    mesh = make_mesh(device="cpu")
    out = {}
    for name, case in jax_cases.items():
        s = torch_solver(name)
        noise = tuple(torch.tensor(a) for a in case["noise"][rank])
        out[f"jax_{name}"] = _mesh_value_and_grad(
            s.build_loss_from_noise(case["batch"]),
            params_from_jax(case["params"], "cpu"), noise, mesh)

    g = make_generator("cpu", 5)
    # each evaluation draws from fresh shard generators
    shards = lambda: [fold_in(g, i) for i in range(WORLD)]
    for name in ("merton_direct", "merton_cheb", "merton_hoisted",
                 "merton_adjoint"):
        s = torch_solver(name)
        p = s.init_params(make_generator("cpu", 1, 0))
        loss_fn = s.build_loss(16)
        res = {"mesh_loss": float(make_dp_loss(loss_fn, mesh)(
            p, shards()[rank]))}
        res["mesh"] = _mesh_value_and_grad(loss_fn, p, shards()[rank], mesh)
        if rank == 0:
            res["serial_losses"] = [float(loss_fn(p, x)) for x in shards()]
            res["serial"] = _serial_value_and_grad(loss_fn, p, shards())
        out[name] = res

    # an update and an epoch move the parameters
    s = torch_solver("merton_direct")
    p = s.init_params(make_generator("cpu", 1, 0))
    p0 = [t.detach().clone() for t in param_leaves(p)]
    update = make_dp_update(s.build_loss(8), make_adam(p, 1e-3), p, mesh)
    l1 = float(update(shards()[rank]))
    moved1 = sum(float((t - u).abs().sum())
                 for t, u in zip(param_leaves(p), p0))
    epoch = make_dp_epoch(s.build_loss(8), make_adam(p, 1e-3), p, mesh, 5)
    l2 = epoch(fold_in(make_generator("cpu", 6), rank))
    moved2 = sum(float((t - u).abs().sum())
                 for t, u in zip(param_leaves(p), p0))
    out["update"] = dict(l1=l1, l2=l2, moved1=moved1, moved2=moved2)

    # the compensator's nodes sharded over (data 2, comp 2), against the
    # same world unsharded at the same noise
    mesh2 = make_mesh((2, 2), ("data", "comp"), device="cpu")
    gen = fold_in(make_generator("cpu", 9), mesh2.coord("data"))
    cases = {"quad_xla": (QUAD13, "xla"), "quad_pallas": (QUAD13, "pallas"),
             "mc_xla": (dict(kind="mc", n_mc=8), "xla"),
             "mc_pallas": (dict(kind="mc", n_mc=8), "pallas")}
    for label, (comp, impl) in cases.items():
        base = torch_solver("merton_direct", comp=comp, sweep_impl=impl)
        shard = torch_solver("merton_direct", comp=comp, sweep_impl=impl,
                             comp_axis="comp", comp_shards=2)
        p = base.init_params(make_generator("cpu", 1, 0))
        out[f"comp_{label}"] = {
            "unsharded": _mesh_value_and_grad(
                base.build_loss(16), p, fold_in(gen, 0), mesh2),
            "sharded": _mesh_value_and_grad(
                shard.build_loss(16, mesh2), p, fold_in(gen, 0), mesh2)}

    # fit under the mesh against the serial fit of the mesh mean, by SGD
    s = torch_solver("merton_direct")
    sgd = lambda leaves: torch.optim.SGD(leaves, lr=SGD_LR)
    common = dict(seed=7, lrate=1e-3, num_epoch=3, num_epoch_ext=2,
                  y0_fn=s.y0_estimate, verbose=False, optimizer=sgd)
    res = fit(s.build_loss(8), s.init_params(make_generator("cpu", 1, 0)),
              val_loss_fn=s.build_loss(8), mesh=mesh, **common)
    out["fit"] = {"params": [t.detach().numpy().copy()
                             for t in param_leaves(res.params)],
                  "loss": res.loss_history, "y0": res.y0_history,
                  "digest": digest(res.params)}
    if rank == 0:
        ser = fit(SerialMeshMean(s.build_loss(8), WORLD),
                  s.init_params(make_generator("cpu", 1, 0)),
                  val_loss_fn=SerialMeshMean(s.build_loss(8), WORLD),
                  **common)
        out["fit_serial"] = {"params": [t.detach().numpy().copy()
                                        for t in param_leaves(ser.params)],
                             "loss": ser.loss_history, "y0": ser.y0_history}
    return out


def mfg_mesh_train(rank: int, couplage: str) -> dict:
    """MFGSolver.train on a data mesh of the world (tiny model, global
    batch 32): the histories and a digest of the trained params."""
    mesh = make_mesh(device="cpu")
    solver = MFGSolver(tiny_mfg(), "global", hidden_hat=HIDDEN,
                       hidden=HIDDEN, device="cpu")
    res = solver.train(seed=3, batch=32, batch_val=64, num_epoch=2,
                       num_epoch_ext=2, lrate=1e-3, couplage=couplage,
                       verbose=False, mesh=mesh)
    return {"y0_hat": res.y0_hat_history, "y0": res.y0_history,
            "loss": res.loss_history, "digest": digest(res.params)}


def cli_rank(rank: int, runs) -> list:
    """``cli.main`` of each argument list of ``runs`` in turn on this rank:
    their exit codes."""
    from deepfbsdejsolvers_torch.experiments.cli import main

    return [main(list(argv)) for argv in runs]


def pricing_resume(rank: int, outdir: str) -> dict:
    """The Merton pipeline under a data mesh of the world: 3 outer epochs
    uncut, and 2 then a resume to 3 from the checkpoint of epoch 1; the
    third epoch's records and the trained params of both."""
    from deepfbsdejsolvers_torch.experiments.configs import (
        MertonConfig, RunIO)
    from deepfbsdejsolvers_torch.experiments.pricing import run_pricing

    def run(sub, epochs, resume):
        cfg = MertonConfig(nb_neuron=8, n_epoch_ext=epochs, n_epoch=2,
                           batch_size=8, methods=("Global",), seed=4,
                           data_parallel=True, n_poisson_max=3, n_hermite=4,
                           io=RunIO(outdir=f"{outdir}/{sub}",
                                    checkpoint_every=1, resume=resume))
        r = run_pricing(cfg, verbose=False, device="cpu").methods["Global"]
        return {"y0": r.y0_history, "loss": r.loss_history,
                "params": [t.detach().numpy().copy()
                           for t in param_leaves(r.params)],
                "digest": digest(r.params)}

    return {"uncut": run("uncut", 3, False), "cut": run("cut", 2, False),
            "resumed": run("cut", 3, True)}


def raise_on_rank_one(rank: int) -> int:
    """Rank 1 raises; the others wait for it at a barrier."""
    if rank == 1:
        raise ValueError("rank 1 fails")
    torch.distributed.barrier()
    return rank


def hang_on_rank_one(rank: int) -> int:
    """Rank 1 never returns."""
    import time

    while rank == 1:
        time.sleep(1.0)
    return rank
