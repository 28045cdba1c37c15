"""The readers of the metrics that read the program's spans and set-up
counters (``deepfbsdejsolvers_torch/utils/profiling.py``): None from a
recorder that holds nothing, and the number expected from a recorder
filled by hand (two steps, their events' times given)."""

import types

import pytest

from benchmark import harness
from deepfbsdejsolvers_torch.utils import profiling

SPAN_METRICS = {            # metric: (span, summary key)
    "host_ms_per_step": ("fbsde.step", "host_ms"),
    "noise_ms_per_step": ("fbsde.noise", "stream_ms"),
    "tables_ms_per_step": ("fbsde.tables", "stream_ms"),
    "price_ms_per_step": ("fbsde.price", "stream_ms"),
    "backward_ms_per_step": ("fbsde.backward", "stream_ms"),
    "optimizer_ms_per_step": ("fbsde.optimizer", "stream_ms"),
}
SETUP_METRICS = {"setup_kernels_s": "setup.kernels",
                 "setup_optimizer_s": "setup.optimizer"}
NEW = ["host_ms_per_step", "host_ms_per_step.parity", "noise_ms_per_step",
       "noise_ms_per_step.parity", "tables_ms_per_step",
       "price_ms_per_step.parity", "backward_ms_per_step",
       "backward_ms_per_step.parity", "optimizer_ms_per_step",
       "optimizer_ms_per_step.parity", "setup_kernels_s",
       "setup_optimizer_s"]
RUN = types.SimpleNamespace(trace=None)


class _Event:
    """A CUDA event's stand-in: its time on the stream, in ms."""

    def __init__(self, ms):
        self.ms = ms

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return other.ms - self.ms


def _put(rec, sid, name, parent, step, host, stream):
    s = profiling._Span(rec, name)
    s.sid, s.parent, s.step = sid, parent, step
    s.t0, s.t1 = (int(round(v * 1e6)) for v in host)
    s.e0, s.e1 = _Event(stream[0]), _Event(stream[1])
    rec._keep(s)


def _filled():
    """Two steps of the fused cell's shape: (host ms, stream ms) of each
    span given, the optimizer twice a step, the price inside the tables."""
    rec = profiling.SpanRecorder()
    for k, (base, scale) in enumerate(((0.0, 1.0), (100.0, 2.0))):
        sid = 10 * k
        at = lambda a, b: (base + scale * a, base + scale * b)
        _put(rec, sid + 1, "fbsde.optimizer", sid, k, at(0, 0.5), at(0, 1))
        _put(rec, sid + 2, "fbsde.noise", sid, k, at(1, 2), at(1, 3))
        _put(rec, sid + 4, "fbsde.price", sid + 3, k, at(3, 4), at(4, 5))
        _put(rec, sid + 3, "fbsde.tables", sid, k, at(2, 5), at(3, 9))
        _put(rec, sid + 5, "fbsde.backward", sid, k, at(5, 8), at(9, 20))
        _put(rec, sid + 6, "fbsde.optimizer", sid, k, at(8, 9), at(20, 22))
        _put(rec, sid, "fbsde.step", None, k, at(0, 10), at(0, 23))
    rec.setup_add("setup.kernels", 0.25, builds=0, libraries=2)
    rec.setup_add("setup.kernels", 0.5, builds=1, libraries=1)
    rec.setup_add("setup.optimizer", 7.0, constructions=1)
    rec.setup_add("setup.optimizer", 1.5, first_steps=1)
    return rec


# the medians over the two steps, whose times are 1x and 2x these
EXPECTED = {"host_ms_per_step": 15.0, "noise_ms_per_step": 3.0,
            "tables_ms_per_step": 9.0, "price_ms_per_step": 1.5,
            "backward_ms_per_step": 16.5, "optimizer_ms_per_step": 4.5,
            "setup_kernels_s": 0.75, "setup_optimizer_s": 8.5}


@pytest.mark.parametrize("metric", NEW)
def test_reader_reads_none_from_an_empty_recorder(metric, monkeypatch):
    monkeypatch.setattr(profiling, "RECORDER", profiling.SpanRecorder())
    assert harness.load_metric(metric)(RUN) is None


@pytest.mark.parametrize("metric", NEW)
def test_reader_reads_a_recorder_filled_by_hand(metric, monkeypatch):
    monkeypatch.setattr(profiling, "RECORDER", _filled())
    got = harness.load_metric(metric)(RUN)
    assert got == pytest.approx(EXPECTED[metric.split(".")[0]], abs=1e-9)


def test_summary_of_the_filled_recorder():
    summ = _filled().summary()
    assert summ["steps"] == 2
    step, tables = summ["spans"]["fbsde.step"], summ["spans"]["fbsde.tables"]
    assert step["calls"] == 1 and summ["spans"]["fbsde.optimizer"][
        "calls"] == 2
    # self time: the step less its children, the tables less the price
    assert step["self_stream_ms"] == pytest.approx(1.5 * (23 - 22))
    assert step["self_host_ms"] == pytest.approx(1.5 * (10 - 8.5))
    assert tables["self_stream_ms"] == pytest.approx(1.5 * (6 - 1))


def test_a_step_partly_dropped_from_the_ring_is_left_out():
    rec = profiling.SpanRecorder(capacity=10)
    src = _filled()
    for s in src._ring:
        rec._keep(s)
    summ = rec.summary()
    assert summ["steps"] == 1
    assert summ["spans"]["fbsde.step"]["host_ms"] == pytest.approx(20.0)


def test_the_new_entries_are_in_the_benchmark():
    names = [m["name"] for m in harness.load_json(
        harness.ROOT / "BENCHMARK.json")["per_layer"]]
    assert names[-len(NEW):] == NEW
    assert set(SPAN_METRICS) | set(SETUP_METRICS) == {
        n.split(".")[0] for n in NEW}
