"""Functional MLP heads for the Y/Z/Γ approximators.

Parameters are a plain dict ``{"W": [...], "b": [...], ("y0": scalar)}`` of
tensors with the JAX package's (in, out) weight layout, so parameters carried
across from the JAX package compare like with like
(``utils/convert.py``).  Glorot-normal kernels, zero biases, an optional
trainable scalar ``y0`` drawn from the unit normal.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Sequence

import torch

Params = Dict[str, object]


def get_activation(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """Map an activation name to a function."""
    table = {"tanh": torch.tanh, "relu": torch.relu, "sigmoid": torch.sigmoid}
    if name not in table:
        raise ValueError(
            f"activation must be one of {sorted(table)}, got {name!r}")
    return table[name]


@dataclasses.dataclass(frozen=True)
class MLPSpec:
    """Static description of one MLP head; ``with_y0`` adds the trainable
    scalar ``y0`` that the global solvers use as the initial BSDE value."""

    n_in: int
    hidden: Sequence[int]
    n_out: int
    activation: str = "tanh"
    with_y0: bool = False

    def __post_init__(self):
        object.__setattr__(self, "hidden", tuple(int(h) for h in self.hidden))

    @property
    def sizes(self) -> tuple:
        return (self.n_in, *self.hidden, self.n_out)


def init_mlp(generator: torch.Generator, spec: MLPSpec,
             device="cuda") -> Params:
    """Glorot-normal kernels, zero biases, optional unit-normal scalar y0.

    Drawn on the CPU from ``generator`` (a CPU generator), then moved to
    ``device``, so one seed gives the same weights on every device."""
    sizes = spec.sizes
    ws, bs = [], []
    for n_in, n_out in zip(sizes[:-1], sizes[1:]):
        std = math.sqrt(2.0 / (n_in + n_out))
        ws.append(std * torch.randn((n_in, n_out), generator=generator))
        bs.append(torch.zeros((n_out,)))
    params: Params = {"W": [w.to(device) for w in ws],
                      "b": [b.to(device) for b in bs]}
    if spec.with_y0:
        params["y0"] = torch.randn((), generator=generator).to(device)
    return params


def compute_dtype_of(name: Optional[str]) -> Optional[torch.dtype]:
    """The torch dtype of a ``compute_dtype`` name: None (or "float32") for
    f32 throughout, "bfloat16" for bf16 matmuls."""
    if name is None or name == "float32":
        return None
    if name == "bfloat16":
        return torch.bfloat16
    raise ValueError(f"compute_dtype must be None, 'float32' or 'bfloat16', "
                     f"got {name!r}")


def mlp_apply(params: Params, x: torch.Tensor,
              activation: Callable[[torch.Tensor], torch.Tensor] = torch.tanh,
              compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Forward pass: x (..., n_in) -> (..., n_out).  With ``compute_dtype``
    (bf16) the input, weights and biases are cast to it and every layer runs
    there, as the JAX package's ``mlp_apply`` does (on the card the tensor
    cores sum a bf16 product in f32); the output is cast back."""
    out_dtype = x.dtype
    if compute_dtype is not None:
        x = x.to(compute_dtype)
    n = len(params["W"])
    for i, (w, b) in enumerate(zip(params["W"], params["b"])):
        if compute_dtype is not None:
            w, b = w.to(compute_dtype), b.to(compute_dtype)
        x = torch.matmul(x, w) + b
        if i < n - 1:
            x = activation(x)
    return x if compute_dtype is None else x.to(out_dtype)


def param_leaves(params) -> list:
    """The tensors of a params tree, in a fixed order (dict keys sorted,
    lists in order)."""
    if isinstance(params, dict):
        return [t for k in sorted(params) for t in param_leaves(params[k])]
    if isinstance(params, (list, tuple)):
        return [t for p in params for t in param_leaves(p)]
    return [params]
