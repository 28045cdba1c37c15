"""Checkpoints and deterministic resume.

The reference has no checkpointing: training restarts from scratch
(SURVEY.md §5).  Here a training state is a dict of tensors and plain
values, written with ``torch.save`` and read with
``torch.load(weights_only=True)``: the parameter leaves (``param_leaves``
order), ``optimizer.state_dict()``, the seed and the epoch.  No generator
state is saved: ``fit`` draws outer epoch k's noise from generators seeded
by (seed, 1, 2k) and (seed, 1, 2k + 1) (``solvers/train.py``), so a run
resumed at epoch k replays the noise the uncut run drew, as the JAX
package's ``fold_in`` of the epoch into a saved key does.

Layout: ``root/step_<n>/state.pt`` per save, the oldest pruned beyond
``keep``.  Each file is written under a temporary name and renamed into
place (``os.replace``), so a run killed mid-write never leaves a partial
file as the latest checkpoint.  Under a mesh (``parallel/data_parallel.py``)
rank 0 alone writes, and every rank waits at a barrier after each save
before it goes on; every rank reads a restore.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Optional, Tuple

import torch

_STATE = "state.pt"


def save_checkpoint(path: str, state: Any) -> None:
    """Write ``state`` (tensors, dicts, lists, numbers, strings) into the
    directory ``path``, replacing any checkpoint there."""
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, f"{_STATE}.tmp-{os.getpid()}")
    torch.save(state, tmp)
    os.replace(tmp, os.path.join(path, _STATE))


def restore_checkpoint(path: str, map_location=None) -> Any:
    """The state saved by :func:`save_checkpoint` in ``path``, its tensors
    on ``map_location`` (where they were saved by default)."""
    return torch.load(os.path.join(path, _STATE), map_location=map_location,
                      weights_only=True)


class CheckpointManager:
    """The latest ``keep`` checkpoints under ``root``, one ``step_<n>/``
    directory per save; under ``mesh`` written by rank 0 alone."""

    def __init__(self, root: str, keep: int = 3, mesh=None):
        self.root = os.path.abspath(root)
        self.keep = keep
        self.mesh = mesh
        self._writes = mesh is None or mesh.rank == 0
        if self._writes:
            os.makedirs(self.root, exist_ok=True)

    def _steps(self):
        """(step, directory) of every complete checkpoint, oldest first."""
        out = []
        if not os.path.isdir(self.root):
            return out
        for name in os.listdir(self.root):
            path = os.path.join(self.root, name)
            if (name.startswith("step_") and name[5:].isdigit()
                    and os.path.isfile(os.path.join(path, _STATE))):
                out.append((int(name[5:]), path))
        return sorted(out)

    def save(self, step: int, state: Any) -> str:
        path = os.path.join(self.root, f"step_{step}")
        if self._writes:
            save_checkpoint(path, state)
            steps = self._steps()
            for _, victim in steps[:max(0, len(steps) - self.keep)]:
                shutil.rmtree(victim, ignore_errors=True)
        if self.mesh is not None:
            self.mesh.barrier()
        return path

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1][0] if steps else None

    def restore_latest(self, map_location=None
                       ) -> Optional[Tuple[int, Any]]:
        """(step, state) of the newest checkpoint, or None."""
        step = self.latest_step()
        if step is None:
            return None
        return step, restore_checkpoint(
            os.path.join(self.root, f"step_{step}"), map_location)
