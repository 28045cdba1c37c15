"""The window's arithmetic, and the trace's attribution on a small
synthetic trace."""

import statistics

import pytest

from benchmark import stats, trace


def test_percentile_interpolates():
    vals = list(range(1, 11))
    assert stats.percentile(vals, 90) == pytest.approx(9.1)
    assert stats.percentile(vals, 50) == pytest.approx(5.5)
    assert stats.percentile([3.0], 90) == 3.0
    assert stats.percentile(vals, 90) == pytest.approx(
        statistics.quantiles(vals, n=10, method="inclusive")[8])


def test_throughput():
    assert stats.throughput(2 ** 19, 50, 1000, 10.0) == 2 ** 19 * 50 * 100
    with pytest.raises(ValueError):
        stats.throughput(1, 1, 1, 0.0)


def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid, "pid": 1, "args": args}


def test_summarize_attributes_by_launching_op():
    layers = {"rollout_fwd": ["FusedRollout"],
              "rollout_bwd": ["FusedRolloutBackward"]}
    ev = [
        _x("cpu_op", "step", 0, 1000),
        _x("cpu_op", "FusedRollout", 10, 100, **{"External id": 1}),
        _x("cuda_runtime", "cudaLaunchKernel", 20, 5, correlation=11),
        _x("kernel", "fwd_kernel", 200, 300, tid=7, correlation=11,
           **{"External id": 1}),
        _x("cpu_op", "aten::mul", 150, 20, **{"External id": 2}),
        _x("cuda_runtime", "cudaLaunchKernel", 155, 5, correlation=12),
        _x("kernel", "elementwise", 600, 100, tid=7, correlation=12),
        _x("cpu_op", "FusedRolloutBackward", 300, 100, tid=2,
           **{"External id": 3}),
        # no runtime event: found by its External id
        _x("kernel", "bwd_kernel", 800, 50, tid=7, correlation=99,
           **{"External id": 3}),
    ]
    s = trace.summarize(ev, layers, steps=2, window_s=0.002)
    assert s.layer_s == pytest.approx({"rollout_fwd": 300e-6,
                                       "eager": 100e-6,
                                       "rollout_bwd": 50e-6})
    assert s.layer_ops == {"rollout_fwd": 1, "eager": 1, "rollout_bwd": 1}
    assert s.op_calls == {"FusedRollout": 1, "FusedRolloutBackward": 1}
    assert s.busy_s == pytest.approx(450e-6)
    assert s.n_device_ops == 3
    assert s.device_ops[0] == ("fwd_kernel", pytest.approx(300e-6))
    # the gaps 500-600 and 700-800 both fall inside "step" on thread 1
    assert [g[0] for g in s.idle_gaps] == ["step", "step"]
    assert trace.roofline_share(s, "rollout_fwd", "FusedRollout",
                                150e-6) == pytest.approx(50.0)
    assert trace.roofline_share(s, "sweep_fwd", "FusedSweep", 1.0) is None
