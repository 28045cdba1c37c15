"""The port's instruments (utils/profiling.py, utils/debug.py):
``trace_profile`` as a no-op without a directory and writing a
``torch.profiler`` trace on the CPU (its spans: ``test_torch_tracing.py``),
and the NaN guard raising on a non-finite loss and on a NaN gradient, leaving
autograd's anomaly mode as it found it."""

import json
import math

import pytest
import torch

from deepfbsdejsolvers_torch.solvers.train import fit
from deepfbsdejsolvers_torch.utils.debug import nan_guard
from deepfbsdejsolvers_torch.utils.profiling import trace_profile


def test_trace_profile_none_is_a_no_op(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with trace_profile(None):
        x = torch.ones(3) * 2
    assert float(x.sum()) == 6.0
    assert list(tmp_path.iterdir()) == []


def test_trace_profile_writes_a_trace_on_the_cpu(tmp_path):
    logdir = tmp_path / "trace"
    with trace_profile(str(logdir)):
        torch.matmul(torch.ones(16, 16), torch.ones(16, 16)).sum()
    files = sorted(p.name.split("_")[0] for p in logdir.iterdir())
    assert files == ["spans", "trace"]
    (trace,) = logdir.glob("trace_*.json")
    events = json.loads(trace.read_text())["traceEvents"]
    assert any("matmul" in e.get("name", "") for e in events)


def _fit(loss_fn, params, **kw):
    return fit(loss_fn=loss_fn, params=params, seed=0, lrate=1e-2,
               num_epoch=2, num_epoch_ext=1, verbose=False, **kw)


def test_nan_guard_raises_on_a_poisoned_loss():
    poisoned = lambda p, g: (p["w"] * float("nan")).sum()
    anomaly = (torch.is_anomaly_enabled(),
               torch.is_anomaly_check_nan_enabled())
    with nan_guard():
        assert torch.is_anomaly_enabled()
        with pytest.raises(FloatingPointError, match="non-finite"):
            _fit(poisoned, {"w": torch.ones(3)})
    assert (torch.is_anomaly_enabled(),
            torch.is_anomaly_check_nan_enabled()) == anomaly
    # without the guard the poisoned run trains on, its loss NaN
    res = _fit(poisoned, {"w": torch.ones(3)})
    assert math.isnan(res.loss_history[0])
    with nan_guard(enable=False):
        assert not torch.is_anomaly_enabled()


def test_nan_guard_raises_on_a_nan_gradient():
    """A finite loss whose backward makes a NaN (a zero cotangent through
    d√u at u = 0, 0 / 0): anomaly mode names the backward function."""
    def loss(p, g):
        return (torch.sqrt(p["w"] - p["w"]) * 0.0).sum() + p["w"].sum()

    with nan_guard(), pytest.raises(RuntimeError, match="SqrtBackward"):
        _fit(loss, {"w": torch.ones(3)})
    assert not torch.is_anomaly_enabled()
