"""The chunked time loop: the JAX package's ``chunked_scan`` as an eager loop.

The port has no scan: its time loops are Python loops over the steps.  What
``scan_chunk`` changes here is only what autograd keeps for the backward.
``chunked_scan(body, carry, xs, length, chunk, remat)`` runs
``body(carry, xs_i) -> (carry, y_i)`` for i = 0 … length − 1 and returns
the last carry and the y_i stacked along a new leading axis, as
``lax.scan`` does.  Under ``remat`` it checkpoints (``torch.utils.
checkpoint``, non-reentrant) the steps in chunks of k: the largest divisor
of ``length`` not above ``chunk``, as the JAX package picks it, so that
``chunk=2`` on an odd length degrades to one step a chunk, and ``chunk <= 1``
or ``chunk >= length`` means one step a chunk too.  The forward of a chunk
keeps only its inputs; the backward replays the chunk.  The ops are the
same either way, so the loss and every gradient equal those of the plain
loop bit for bit.

The JAX package's pricing solver passes a policy that saves its heads'
outputs ("gam", "comp") beside a chunk's inputs.  In an eager replay that
saves no work: the heads' own backward needs their activations, so the
replay runs them all the same, and a value kept from the forward has the
bits the replay recomputes.  So the port keeps only the chunk's inputs and
takes no policy; a selective checkpoint (``create_selective_checkpoint_
contexts``) would keep the same values at the cost of a Python dispatch per
op of the chunk, which doubled the host-bound speed step on an H100.

``xs`` is None (the length-only idiom) or a pytree whose leaves are indexed
by the step: tensors along their leading axis, or any sequence (a
``range`` gives the body the step as a Python int).
"""

from __future__ import annotations

from typing import Any, Callable

import torch
from torch.utils import _pytree as pytree
from torch.utils.checkpoint import checkpoint

__all__ = ["chunk_size", "chunked_scan"]


def chunk_size(length: int, chunk: int) -> int:
    """Steps per chunk of ``chunked_scan``: the largest divisor of
    ``length`` not above ``chunk``; 1 (a step a chunk) when ``chunk <= 1``
    or ``chunk >= length``."""
    k = chunk
    if k and 1 < k < length:
        while length % k:
            k -= 1
    if not k or k <= 1 or k >= length:
        return 1
    return k


def _at(xs, i):
    return pytree.tree_map(lambda a: None if a is None else a[i], xs)


def _run(body, carry, xs, lo: int, hi: int):
    """Steps lo … hi − 1 of the loop: (carry, [y_lo, …])."""
    ys = []
    for i in range(lo, hi):
        carry, y = body(carry, _at(xs, i))
        ys.append(y)
    return carry, ys


def _stack(ys):
    if not ys or ys[0] is None:
        return None
    return pytree.tree_map(
        lambda *leaves: None if leaves[0] is None else torch.stack(leaves),
        *ys)


def chunked_scan(body: Callable, carry: Any, xs: Any, length: int,
                 chunk: int = 0, remat: bool = False):
    """``(carry, ys)`` of ``body`` over ``length`` steps, checkpointed in
    chunks under ``remat`` (module docstring)."""
    if not (remat and torch.is_grad_enabled()):
        carry, ys = _run(body, carry, xs, 0, length)
        return carry, _stack(ys)
    k = chunk_size(length, chunk)
    ys = []
    for lo in range(0, length, k):
        carry, part = checkpoint(_run, body, carry, xs, lo, lo + k,
                                 use_reentrant=False, preserve_rng_state=False,
                                 determinism_check="none")
        ys.extend(part)
    return carry, _stack(ys)
