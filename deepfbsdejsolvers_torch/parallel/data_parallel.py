"""Data parallelism over paths, and the compensator's node axis sharded,
with ``torch.distributed``: one process per rank.

* **data** axis: each data rank rolls out its own shard of the paths with
  its own noise (``fit`` draws it from a generator of the data
  coordinate); the mesh loss is the mean of the per-rank losses.
* **comp** axis (``PricingSolver(comp_axis=..., comp_shards=...,
  mesh=...)``): the ranks of one data shard draw the same paths, and each
  sweeps its own slice of the compensator's node set; the weighted partial
  sums are summed over the axis by ``psum``, whose backward sums the
  cotangents over the axis again (the transpose of a sum over ranks).

Parameters and the optimizer's state are replicated: ``broadcast_params``
copies rank 0's parameters to every rank when a fit starts, and every
update applies the same gradients to the same state.  An update takes the
backward of the rank's own loss and then one all-reduce of the flattened
gradients (``all_reduce_grads``), averaged over every rank of the mesh.
That average is the gradient of the mesh-mean loss: the loss's replicated
part is counted once per rank and divided by the rank count, and the Γ
head's per-slice parts, each counted ``comp_shards`` times by the psum's
backward, sum over the axis.  So the update equals the one-process gradient
of the mean of the data shards' losses, as the JAX package's gradient of
its ``shard_map`` loss does.

The backend is NCCL where each rank has a card of its own, gloo on the CPU
or where ranks share one card (NCCL refuses two ranks on one card; gloo
stages CUDA tensors through host memory).  NCCL that fails to initialise
raises; nothing falls back to gloo.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from datetime import timedelta
from typing import Callable, Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from deepfbsdejsolvers_torch.nets.mlp import param_leaves


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's view of a mesh of ranks over named axes, row-major (the
    last axis varies fastest), as the JAX package's mesh of devices
    reshaped to its axis sizes.  ``groups[axis]`` is the process group of
    the ranks that differ from this one on ``axis`` alone (None where the
    axis has size 1); ``device`` is where this rank's tensors live."""

    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    rank: int
    device: torch.device
    backend: str
    groups: Dict[str, Optional[dist.ProcessGroup]]
    owns_world: bool = False

    @property
    def shape(self) -> Dict[str, int]:
        """Each axis's size, by name."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        """The number of ranks."""
        return int(np.prod(self.axis_sizes))

    def coord(self, axis: str) -> int:
        """This rank's coordinate on ``axis``."""
        coords = np.unravel_index(self.rank, self.axis_sizes)
        return int(coords[self.axis_names.index(axis)])

    def barrier(self) -> None:
        dist.barrier()

    def close(self) -> None:
        """Leave the process group if ``make_mesh`` created it."""
        if self.owns_world and dist.is_initialized():
            dist.destroy_process_group()


def _launcher_env() -> Optional[Tuple[int, int, int, int]]:
    """(rank, world size, local rank, local world size) from a launcher's
    environment (``torch.distributed.run``), or None outside one."""
    env = os.environ
    if "RANK" not in env or "WORLD_SIZE" not in env:
        return None
    rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
    return (rank, world, int(env.get("LOCAL_RANK", rank)),
            int(env.get("LOCAL_WORLD_SIZE", world)))


def init_world(device="cuda", init_method: Optional[str] = None,
               rank: Optional[int] = None, world_size: Optional[int] = None,
               timeout_s: float = 1800.0) -> Tuple[str, torch.device]:
    """Join the world of ranks: at ``init_method`` as ``rank`` of
    ``world_size`` (all on this host) when given, else from a launcher's
    environment, else as a world of one.  Returns (backend, this rank's
    device).  Every rank on a card of its own: NCCL, the rank's card made
    current; else gloo.  A sum over the world checks that every rank
    joined."""
    dev = torch.device(device)
    if rank is not None:
        local_rank, local_world = rank, world_size
    elif _launcher_env() is not None:
        rank, world_size, local_rank, local_world = _launcher_env()
        init_method = "env://"
    else:
        rank, world_size, local_rank, local_world = 0, 1, 0, 1
    kw = dict(rank=rank, world_size=world_size,
              timeout=timedelta(seconds=timeout_s))
    if init_method is None:
        kw["store"] = dist.HashStore()
    else:
        kw["init_method"] = init_method
    if dev.type == "cuda" and torch.cuda.device_count() >= local_world:
        backend, dev = "nccl", torch.device("cuda", local_rank)
        torch.cuda.set_device(dev)
        # eager: a communicator that cannot form raises here
        dist.init_process_group("nccl", device_id=dev, **kw)
        why = f"{local_world} rank(s) on this host, each on a card of its own"
    else:
        backend = "gloo"
        if dev.type == "cuda":
            dev = torch.device("cuda", torch.cuda.current_device())
            why = (f"{local_world} ranks share {torch.cuda.device_count()} "
                   "card(s)")
        else:
            why = "the CPU"
        dist.init_process_group("gloo", **kw)
    ones = torch.ones(1, device=dev)
    dist.all_reduce(ones)
    if int(ones.item()) != world_size:
        raise RuntimeError(f"the world's sum of ones is {ones.item()}, not "
                           f"{world_size}")
    if rank == 0:
        print(f"data parallel: {world_size} rank(s), backend {backend} "
              f"({why})", flush=True)
    return backend, dev


def make_mesh(axis_sizes: Optional[Sequence[int]] = None,
              axis_names: Sequence[str] = ("data",), device="cuda") -> Mesh:
    """A mesh over every rank of the world, joining it first when this
    process has not (``init_world``: a launcher's world, else a world of
    one): a data mesh over the whole world by default.  Every rank must
    call it alike, since each axis's groups are formed by all ranks."""
    owns = not dist.is_initialized()
    if owns:
        backend, dev = init_world(device)
    else:
        backend = dist.get_backend()
        dev = torch.device(device)
        if dev.type == "cuda":
            dev = torch.device("cuda", torch.cuda.current_device())
    world, rank = dist.get_world_size(), dist.get_rank()
    sizes = (world,) if axis_sizes is None else tuple(int(s) for s in
                                                      axis_sizes)
    if len(sizes) != len(axis_names) or int(np.prod(sizes)) != world:
        raise ValueError(f"mesh {sizes} over axes {tuple(axis_names)} does "
                         f"not cover the {world} rank(s)")
    ranks = np.arange(world).reshape(sizes)
    groups = {}
    for k, name in enumerate(axis_names):
        if sizes[k] == 1:
            groups[name] = None
        elif sizes[k] == world:
            groups[name] = dist.group.WORLD
        else:
            # every line along axis k is a group; every rank forms them all
            lines = np.moveaxis(ranks, k, -1).reshape(-1, sizes[k])
            for line in lines:
                group = dist.new_group([int(r) for r in line])
                if rank in line:
                    groups[name] = group
    return Mesh(tuple(axis_names), sizes, rank, dev, backend, groups, owns)


@contextlib.contextmanager
def optional_mesh(data_parallel: bool, device="cuda") -> Iterator[
        Optional[Mesh]]:
    """A data mesh over the launcher's world (a world of one without a
    launcher) while the block runs, or None when ``data_parallel`` is
    off; the world is left afterwards if the mesh joined it."""
    if not data_parallel:
        yield None
        return
    mesh = make_mesh(device=device)
    try:
        yield mesh
    finally:
        mesh.close()


def per_shard_batch(global_batch: int, mesh: Mesh,
                    data_axis: str = "data") -> int:
    """Paths each data rank rolls out so that the mesh covers
    ``global_batch`` (rounded up: the effective global batch is this times
    the data ranks)."""
    n = mesh.shape[data_axis]
    return max(1, -(-int(global_batch) // int(n)))


class _Psum(torch.autograd.Function):
    """The sum over a process group; its backward is the same sum of the
    cotangents (the transpose of a sum over ranks)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def psum(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """The sum of ``x`` over ``axis``, differentiable: its backward sums
    the cotangents over the axis."""
    group = mesh.groups[axis]
    return x if group is None else _Psum.apply(x, group)


def _flat(tensors) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in tensors])


def broadcast_params(params, mesh: Mesh) -> None:
    """Copy rank 0's parameter leaves to every rank, in place."""
    leaves = param_leaves(params)
    with torch.no_grad():
        flat = _flat(leaves)
        dist.broadcast(flat, src=0)
        for t, v in zip(leaves, flat.split([t.numel() for t in leaves])):
            t.copy_(v.view_as(t))


def all_reduce_grads(leaves, loss: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """After each rank's backward of its own ``loss``: average the leaves'
    gradients and the loss over every rank of the mesh, in one all-reduce
    of them flattened, and return the mesh-mean loss.  A leaf without a
    gradient counts as zeros."""
    grads = [t.grad if t.grad is not None else torch.zeros_like(t)
             for t in leaves]
    flat = _flat(grads + [loss.detach()])
    dist.all_reduce(flat)
    flat /= mesh.size
    parts = flat.split([t.numel() for t in leaves] + [1])
    for t, v in zip(leaves, parts):
        t.grad = v.view_as(t)
    return parts[-1][0]


def all_ranks_true(flag: bool, mesh: Mesh) -> bool:
    """Whether ``flag`` holds on every rank."""
    n = torch.tensor([0.0 if flag else 1.0], device=mesh.device)
    dist.all_reduce(n)
    return float(n.item()) == 0.0


def make_dp_loss(loss_fn: Callable, mesh: Mesh) -> Callable:
    """``dp_loss(params, x)``: the mean over every rank of the mesh of
    ``loss_fn(params, x)``, each rank passing its own ``x`` (its shard's
    generator or noise), as a value; the updates below take the
    gradients."""

    def dp_loss(params, x):
        local = loss_fn(params, x).detach().reshape(1).clone()
        dist.all_reduce(local)
        return local[0] / mesh.size

    return dp_loss


def make_dp_update(loss_fn: Callable, optimizer: torch.optim.Optimizer,
                   params, mesh: Mesh, lrate=None,
                   start_count: int = 0) -> Callable:
    """``update(generator) -> mesh loss``: one step of ``optimizer`` on the
    gradient of the mesh-mean loss (``solvers/train.py`` ``make_step``
    with the mesh)."""
    from deepfbsdejsolvers_torch.solvers.train import make_step

    return make_step(loss_fn, optimizer, params, lrate, start_count, mesh)


def make_dp_epoch(loss_fn: Callable, optimizer: torch.optim.Optimizer,
                  params, mesh: Mesh, num_inner: int, lrate=None,
                  start_count: int = 0) -> Callable:
    """``epoch(generator) -> float``: ``num_inner`` updates of
    ``make_dp_update`` on successive draws of ``generator``, and the last
    one's mesh loss, read once at the end."""
    update = make_dp_update(loss_fn, optimizer, params, mesh, lrate,
                            start_count)

    def epoch(generator) -> float:
        for _ in range(num_inner):
            loss = update(generator)
        return float(loss)

    return epoch
