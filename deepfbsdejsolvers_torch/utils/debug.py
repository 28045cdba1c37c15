"""The NaN guard: ``nan_guard()`` turns a non-finite value in training into
an exception at once, instead of Adam training on poisoned parameters.

Of what the JAX package's guard (``jax_debug_nans``) gives, this keeps:
  * a raise in the backward pass at the operation whose gradient is NaN:
    ``torch.autograd.set_detect_anomaly(True, check_nan=True)`` checks
    every backward function's outputs and names the forward operation that
    recorded it, with its traceback;
  * a raise on a non-finite training loss, before its backward and update
    run: ``fit``'s step checks the loss whenever anomaly mode is on.
It does not keep the raise at the exact forward primitive that produced a
NaN: anomaly mode checks backward outputs only, and the loss check sees the
forward's result, not the operation inside it.  Both checks cost time (the
loss check waits for the device once a step), so keep the guard off for
timed runs.  Anomaly mode is per process, like the JAX flag.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def nan_guard(enable: bool = True):
    """Inside the scope: autograd's anomaly mode with its NaN check, and so
    the training step's check of its loss; the previous mode after."""
    if not enable:
        yield
        return
    prev_mode = torch.is_anomaly_enabled()
    prev_nan = torch.is_anomaly_check_nan_enabled()
    torch.autograd.set_detect_anomaly(True, check_nan=True)
    try:
        yield
    finally:
        torch.autograd.set_detect_anomaly(prev_mode, check_nan=prev_nan)
