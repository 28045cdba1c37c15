"""The spans inside the port's training step and the set-up counters
(``utils/profiling.py``), on the CPU at a small batch of the hoisted speed
path (N = 4, hidden (8, 8)): off, a step records nothing and opens no
``record_function``; on, ``fbsde.step`` is the parent of the step's phases,
all of one step; under ``torch.profiler`` the phases are ``user_annotation``
ranges around their own aten ops; spans change no bit of the training; the
set-up counters count once per process; ``trace_profile`` writes the
spans beside its trace."""

import dataclasses
import json

import pytest
import torch

from deepfbsdejsolvers_torch.models.merton import make_merton_default
from deepfbsdejsolvers_torch.nets.mlp import param_leaves
from deepfbsdejsolvers_torch.ops import _build
from deepfbsdejsolvers_torch.ops.compensator import CompensatorSpec
from deepfbsdejsolvers_torch.solvers.pricing import PricingSolver
from deepfbsdejsolvers_torch.solvers.train import make_adam, make_step
from deepfbsdejsolvers_torch.utils import profiling

BATCH = 64
PHASES = ("fbsde.noise", "fbsde.tables", "fbsde.backward",
          "fbsde.optimizer")


@pytest.fixture(scope="module")
def solver():
    model = dataclasses.replace(make_merton_default(
        jump_sampler="icdf", price_mode="chebyshev"), N=4)
    return PricingSolver(model, "global", hidden=(8, 8), device="cpu",
                         compensator=CompensatorSpec(x_interp="chebyshev",
                                                     n_cheb=16),
                         hoist=True, hoist_interp="piecewise")


def _trainer(solver, seed=0):
    """(step, params, generator): a fresh Adam step at fixed weights and
    noise."""
    params = solver.init_params(torch.Generator().manual_seed(seed))
    step = make_step(solver.build_loss(BATCH), make_adam(params, 1e-3),
                     params)
    return step, params, torch.Generator().manual_seed(seed + 1)


def test_spans_off_record_nothing(solver, monkeypatch):
    opened = []
    real = torch.autograd.profiler.record_function

    def watch(name, *args, **kwargs):      # torch's optimizer opens its own
        opened.append(name)
        return real(name, *args, **kwargs)

    monkeypatch.setattr(torch.autograd.profiler, "record_function", watch)
    step, _, gen = _trainer(solver)
    before = profiling.RECORDER.mark()
    for _ in range(2):
        step(gen)
    assert not [n for n in opened if n.startswith("fbsde.")]
    assert profiling.RECORDER.mark() == before
    assert profiling.RECORDER.records(before) == []
    assert profiling.span("fbsde.noise") is profiling.span("fbsde.price")
    assert not profiling.RECORDER.on


def test_spans_on_nest_under_the_step(solver):
    step, _, gen = _trainer(solver)
    since = profiling.RECORDER.mark()
    with profiling.spans():
        step(gen)
        step(gen)
    assert not profiling.RECORDER.on
    recs = profiling.RECORDER.records(since)
    by_id = {r["id"]: r for r in recs}
    roots = [r for r in recs if r["name"] == "fbsde.step"]
    assert len(roots) == 2 and roots[0]["step"] + 1 == roots[1]["step"]
    for root in roots:
        mine = [r for r in recs if r["step"] == root["step"]]
        names = {r["name"] for r in mine}
        assert names == {"fbsde.step", "fbsde.price", *PHASES}
        for r in mine:
            assert root["host_start_ns"] <= r["host_start_ns"]
            assert r["host_end_ns"] <= root["host_end_ns"]
            if r["name"] in PHASES:
                assert r["parent"] == root["id"]
            elif r["name"] == "fbsde.price":    # the hoisted price table
                assert by_id[r["parent"]]["name"] == "fbsde.tables"
            assert r["stream_ms"] is None        # no card
    summ = profiling.span_summary(since)
    assert summ["steps"] == 2
    s = summ["spans"]
    assert s["fbsde.step"]["calls"] == 1
    assert s["fbsde.optimizer"]["calls"] == 2     # zeroing, the update
    assert s["fbsde.step"]["stream_ms"] is None
    kids = sum(s[n]["host_ms"] for n in PHASES)
    assert 0 < kids <= s["fbsde.step"]["host_ms"]
    assert s["fbsde.step"]["self_host_ms"] == pytest.approx(
        s["fbsde.step"]["host_ms"] - kids, abs=1e-3)


def test_spans_are_annotations_in_the_profiler_trace(solver, tmp_path):
    from torch.profiler import ProfilerActivity, profile

    step, _, gen = _trainer(solver)
    step(gen)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(gen)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X"]
    marks = {}
    for e in events:
        if e.get("cat") == "user_annotation" and e["name"].startswith(
                "fbsde."):
            marks.setdefault(e["name"], []).append(e)
    assert set(marks) == {"fbsde.step", "fbsde.price", *PHASES}

    def inside(e, outer):
        return (outer["ts"] <= e["ts"]
                and e["ts"] + e["dur"] <= outer["ts"] + outer["dur"])

    (root,) = marks["fbsde.step"]
    assert all(inside(e, root) for name in PHASES for e in marks[name])
    (noise,) = marks["fbsde.noise"]
    draws = [e for e in events if e.get("cat") == "cpu_op"
             and e["name"] in ("aten::randn", "aten::rand")]
    assert len(draws) >= 2 and all(inside(e, noise) for e in draws)


def test_spans_change_no_bit(solver):
    def train(on):
        step, params, gen = _trainer(solver, seed=5)
        with profiling.spans() if on else profiling._OFF:
            losses = [step(gen) for _ in range(2)]
        leaves = param_leaves(params)
        return losses, [t.grad for t in leaves], leaves

    off, on = train(False), train(True)
    for a, b in zip(off, on):
        assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_setup_counters_count_once(solver, monkeypatch):
    step, _, gen = _trainer(solver)
    step(gen)
    first = profiling.setup_counters()["setup.optimizer"]
    assert first["constructions"] == 1 and first["first_steps"] == 1
    assert first["seconds"] > 0
    step2, _, gen2 = _trainer(solver, seed=3)
    step2(gen2)
    assert profiling.setup_counters()["setup.optimizer"] == first

    monkeypatch.setattr(_build, "_LOADED", {})
    monkeypatch.setattr(_build, "build", lambda names: list(names))
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: object())
    before = profiling.setup_counters().get("setup.kernels", {})
    for _ in range(2):
        _build.load("rollout_fwd")
    after = profiling.setup_counters()["setup.kernels"]
    assert after["builds"] == before.get("builds", 0) + 1
    assert after["libraries"] == before.get("libraries", 0) + 1
    assert after["seconds"] > before.get("seconds", 0.0)


def test_trace_profile_writes_the_spans(solver, tmp_path):
    step, _, gen = _trainer(solver)
    step(gen)
    with profiling.trace_profile(str(tmp_path)):
        step(gen)
    (path,) = tmp_path.glob("spans_*.json")
    assert len(list(tmp_path.glob("trace_*.json"))) == 1
    got = json.loads(path.read_text())
    assert got["summary"]["steps"] == 1
    assert set(got["summary"]["spans"]) == {"fbsde.step", "fbsde.price",
                                            *PHASES}
    assert {r["name"] for r in got["spans"]} == set(got["summary"]["spans"])


class _FakeEvent:
    """A CUDA event's stand-in on the CPU: it completes when recorded, at
    the count of records made so far (ms)."""

    made = 0
    clock = 0

    def __init__(self, enable_timing=False):
        _FakeEvent.made += 1
        self.t = None

    def record(self):
        _FakeEvent.clock += 1
        self.t = _FakeEvent.clock

    def query(self):
        return True

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return float(other.t - self.t)


def test_events_are_reused(solver, monkeypatch):
    """A step reads the stream times of the spans the device has passed
    and reuses their events: six steps of seven spans create the first
    step's fourteen events and no more."""
    monkeypatch.setattr(profiling, "RECORDER", profiling.SpanRecorder())
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(_FakeEvent, "made", 0)
    step, _, gen = _trainer(solver)
    with profiling.spans():
        for _ in range(6):
            step(gen)
    assert _FakeEvent.made == 14
    s = profiling.span_summary()
    assert s["steps"] == 6
    # a record at each span's entry and exit: the step's span holds its
    # six spans' twelve; its children cover 1 + 1 + 3 (the tables, the
    # price inside) + 1 + 1 of them
    assert s["spans"]["fbsde.step"]["stream_ms"] == 13.0
    assert s["spans"]["fbsde.step"]["self_stream_ms"] == 13.0 - 7.0
    assert s["spans"]["fbsde.tables"]["self_stream_ms"] == 2.0
