"""Parameters carried between the JAX package and the port.

Both keep the same trees, with (in, out) weights: the pricing solvers'
``{"uz": {"W": [...], "b": [...], "y0": ()}, "gam": {"W": [...], "b":
[...]}}`` and the MFG solvers' ``{"hat": {...}, "full": {...}}`` (each
net ``{"W", "b"}``, with ``"y0"`` in the global scheme), so conversion is
a leaf-by-leaf copy of any tree.  This module takes and gives numpy
arrays, the form both frameworks read, and imports neither JAX nor the JAX
package.
"""

from __future__ import annotations

import numpy as np
import torch


def params_from_jax(tree, device="cuda"):
    """A tree of numpy (or numpy-convertible) arrays -> the same tree of
    float32 tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_jax(v, device) for v in tree]
    return torch.tensor(np.asarray(tree, dtype=np.float32), device=device)


def params_to_jax(params):
    """The inverse: a tree of tensors -> the same tree of numpy arrays."""
    if isinstance(params, dict):
        return {k: params_to_jax(v) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [params_to_jax(v) for v in params]
    return params.detach().cpu().numpy()
