"""Training loop: Adam over ``num_epoch_ext`` outer epochs of ``num_epoch``
inner gradient steps, with a validation loss and the Y0 read-out once per
outer epoch.  Adam uses eps=1e-7 (the Keras default the reference trains
with).  The Y0 read-out is a float, or a tuple of floats where ``y0_fn``
gives a tuple (the MFG solvers' (Y0_hat, Y0) pair).  The learning rate is
a float or a schedule of the update count (``cosine_decay_schedule``, the
gates' schedule).  The noise of outer
epoch k comes from generators seeded by (seed, 1, 2k) and (seed, 1, 2k + 1),
so a run resumed at epoch k with the optimizer's state
(``start_epoch``, ``optimizer_state``; ``utils/checkpointing.py``)
replays the uncut run's remaining epochs bit for bit.  Under a mesh
(``parallel/data_parallel.py``) each data rank folds its data coordinate
into those generators (``fold_in``), so a resumed data-parallel run replays
the uncut one too.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, List, Optional, Union

import numpy as np
import torch

from deepfbsdejsolvers_torch.nets.mlp import param_leaves
from deepfbsdejsolvers_torch.parallel.data_parallel import (
    all_ranks_true, all_reduce_grads, broadcast_params, make_dp_loss)
from deepfbsdejsolvers_torch.utils import profiling


@dataclasses.dataclass
class TrainResult:
    """Trained params, per-outer-epoch Y0 / loss / cumulative seconds."""

    params: Any
    y0_history: List[float]
    loss_history: List[float]
    duration: float
    duration_history: List[float]


def make_generator(device, seed: int, *path: int) -> torch.Generator:
    """A generator on ``device`` whose seed is a pure function of
    (seed, path)."""
    g = torch.Generator(device=device)
    g.manual_seed(int(np.random.SeedSequence([seed, *path]).generate_state(
        1)[0]))
    return g


def fold_in(generator: torch.Generator, i: int) -> torch.Generator:
    """A generator on ``generator``'s device seeded by (its seed, ``i``),
    whatever it has drawn since: the counterpart of ``jax.random.fold_in``,
    with which a data rank derives its shard's generator."""
    return make_generator(generator.device, generator.initial_seed(), i)


LearningRate = Union[float, Callable[[int], float]]


def cosine_decay_schedule(peak: float, steps: int) -> Callable[[int], float]:
    """The learning rate of update ``count`` (0 for the first update):
    peak·(1 + cos(π·min(count, steps)/steps))/2, optax's
    ``cosine_decay_schedule(peak, steps)`` with alpha 0."""
    if steps <= 0:
        raise ValueError(f"steps must be positive, got {steps}")

    def lrate(count: int) -> float:
        return peak * 0.5 * (1.0 + math.cos(math.pi * min(count, steps)
                                            / steps))

    return lrate


# The process's first optimizer and its first update pay torch's first-use
# imports: each is timed once into the set-up counter "setup.optimizer".
_UNTIMED = {"constructions": True, "first_steps": True}


def _timed_once(part: str, fn: Callable):
    """``fn()``, timed into "setup.optimizer" the first time ``part``
    runs in this process."""
    if not _UNTIMED[part]:
        return fn()
    _UNTIMED[part] = False
    t0 = time.perf_counter()
    out = fn()
    profiling.setup_add("setup.optimizer", time.perf_counter() - t0,
                        **{part: 1})
    return out


def make_adam(params, lrate: LearningRate) -> torch.optim.Adam:
    """Adam with eps=1e-7 at ``lrate``, or at its value for the first
    update when it is a schedule (``make_step`` sets it per update)."""
    lr = lrate(0) if callable(lrate) else lrate
    return _timed_once("constructions", lambda: torch.optim.Adam(
        param_leaves(params), lr=lr, eps=1e-7))


def make_step(loss_fn: Callable, optimizer: torch.optim.Optimizer,
              params, lrate: Optional[Callable[[int], float]] = None,
              start_count: int = 0, mesh=None) -> Callable:
    """``step(generator) -> loss``: one gradient step on a fresh draw.  With
    a schedule ``lrate``, the k-th call's update runs at
    ``lrate(start_count + k)``.  With autograd's anomaly mode on (the NaN
    guard, ``utils/debug.py``) a non-finite loss raises FloatingPointError
    before its backward, on every rank of a mesh if it is so on one.
    Under ``mesh`` the step is on the mesh-mean loss, which it returns:
    the backward of this rank's loss, then one all-reduce of the
    gradients (``all_reduce_grads``).  The step is the span "fbsde.step",
    its backward "fbsde.backward", and the optimizer's work (zeroing the
    gradients, the update) "fbsde.optimizer" (``utils/profiling.py``)."""
    count = start_count
    leaves = param_leaves(params)
    for t in leaves:
        t.requires_grad_(True)

    def step(generator):
        nonlocal count
        with profiling.step("fbsde.step"):
            with profiling.span("fbsde.optimizer"):
                if lrate is not None:
                    for group in optimizer.param_groups:
                        group["lr"] = lrate(count)
                optimizer.zero_grad(set_to_none=True)
            loss = loss_fn(params, generator)
            if torch.is_anomaly_enabled():
                finite = bool(torch.isfinite(loss))
                if mesh is not None:
                    finite = all_ranks_true(finite, mesh)
                if not finite:
                    raise FloatingPointError(
                        f"non-finite training loss {float(loss.detach())} "
                        f"at update {count}")
            with profiling.span("fbsde.backward"):
                loss.backward()
            if mesh is not None:
                loss = all_reduce_grads(leaves, loss, mesh)
            with profiling.span("fbsde.optimizer"):
                _timed_once("first_steps", optimizer.step)
            count += 1
            return loss.detach()

    return step


def _floats(y0):
    """A read-out tensor, or a tuple of them, as Python floats."""
    if isinstance(y0, (tuple, list)):
        return tuple(_floats(v) for v in y0)
    return float(y0.detach())


def fit(loss_fn: Callable, params, seed: int, lrate: LearningRate,
        num_epoch: int, num_epoch_ext: int,
        val_loss_fn: Optional[Callable] = None,
        y0_fn: Optional[Callable] = None, verbose: bool = True,
        on_epoch: Optional[Callable[[int, dict, Any], None]] = None,
        start_epoch: int = 0, optimizer_state: Optional[dict] = None,
        mesh=None, data_axis: str = "data",
        optimizer: Optional[Callable[[list], torch.optim.Optimizer]] = None
        ) -> TrainResult:
    """Train ``params`` (leaf tensors, updated in place) for outer epochs
    ``start_epoch`` .. num_epoch_ext − 1 of num_epoch Adam steps each, at
    the learning rate ``lrate``: a float, or a function of the update count
    over the whole fit (epoch k's first update is count k·num_epoch).

    ``val_loss_fn(params, generator)`` is evaluated without gradients once
    per outer epoch; ``y0_fn(params)`` extracts the current Y0 (a tensor
    or a tuple of them).  Epoch k draws its steps' noise from the generator
    seeded by (seed, 1, 2k) and its validation noise from (seed, 1, 2k+1).
    ``on_epoch(k, {"loss", "y0", "duration_s"}, (params, optimizer,
    seed))`` fires after each outer epoch: the hook for metrics logging and
    checkpoints, whose state is the params, ``optimizer.state_dict()``, the
    seed and k.  Resume: ``start_epoch`` = k + 1 and ``optimizer_state``
    that state dict, with ``params`` holding the saved leaves.

    ``mesh`` (``parallel/data_parallel.py``) trains data-parallel:
    ``loss_fn`` and ``val_loss_fn`` are then per-rank losses, built at the
    per-rank batch; rank 0's params are broadcast first; each data rank
    draws from ``fold_in`` of the generators above by its coordinate on
    ``data_axis``; every update is on the mesh-mean loss, and the
    validation loss is the mesh mean.  ``on_epoch`` fires on every rank,
    with the same state on each; only rank 0 prints.  ``optimizer`` maps
    the parameter leaves to the optimizer to train with, Adam at ``lrate``
    by default."""
    leaves = param_leaves(params)
    device = leaves[0].device
    opt = (make_adam(params, lrate) if optimizer is None
           else optimizer(leaves))
    if optimizer_state is not None:
        opt.load_state_dict(optimizer_state)
    step = make_step(loss_fn, opt, params,
                     lrate if callable(lrate) else None,
                     start_count=start_epoch * num_epoch, mesh=mesh)
    shard = lambda g: g
    val_fn = val_loss_fn
    if mesh is not None:
        broadcast_params(params, mesh)
        coord = mesh.coord(data_axis)
        shard = lambda g: fold_in(g, coord)
        if val_loss_fn is not None:
            val_fn = make_dp_loss(val_loss_fn, mesh)
        verbose = verbose and mesh.rank == 0
    y0_hist: List[float] = []
    loss_hist: List[float] = []
    dur_hist: List[float] = []
    duration = 0.0
    for iout in range(start_epoch, num_epoch_ext):
        gen = shard(make_generator(device, seed, 1, 2 * iout))
        t0 = time.perf_counter()
        for _ in range(num_epoch):
            last_loss = step(gen)
        last = float(last_loss)          # waits for the device
        duration += time.perf_counter() - t0
        if val_fn is not None:
            with torch.no_grad():
                obj = float(val_fn(params, shard(make_generator(
                    device, seed, 1, 2 * iout + 1))))
        else:
            obj = last
        y0 = _floats(y0_fn(params)) if y0_fn is not None else float("nan")
        if verbose:
            print(f" Error {obj:.6g}  elapsed time {duration:5.3f} s  "
                  f"Y0 sofar {y0}  epoch {iout}")
        y0_hist.append(y0)
        loss_hist.append(obj)
        dur_hist.append(duration)
        if on_epoch is not None:
            on_epoch(iout, {"loss": obj, "y0": y0, "duration_s": duration},
                     (params, opt, seed))
    return TrainResult(params, y0_hist, loss_hist, duration, dur_hist)
