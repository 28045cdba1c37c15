"""The comparison that decides ``correct`` fails what it must: a run of
each cell on the CPU at a small batch, the harness's look for a card
skipped, with the timed path broken underneath (the step leaves its state
unchanged; half of the batch left out, the mean taken over the rest), and
the control (the reference in TF32 put in the program's place).  The
cells' limits are read from their files.  (The same at each cell's own
size on the card: ``benchmark/calibrate.py``.)"""

import json

import pytest

from benchmark import calibrate, harness

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
BATCH, SEED = 2048, 2 ** 31 + 11


def _fails(numbers: dict, limits: dict) -> bool:
    checks = {k: {"value": numbers[k], "limit": float(v)}
              for k, v in limits.items()}
    return not harness.judge(checks, 0)


@pytest.mark.parametrize("fault", ["frozen", "half_batch"])
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_step_is_not_correct(cell, fault):
    out = harness.run(cell, SEED, 0.2, False, BENCH, device="cpu",
                      plan=harness.Plan(fault=fault), batch=BATCH,
                      log=lambda *a: None)
    assert out["correct"] is False
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    limits = harness.load_cell(cell)[0]["limits"]
    got = calibrate.readings_for(cell, SEED, ["reference_tf32"],
                                 device="cpu", batch=BATCH)
    assert _fails(got["reference_tf32"], limits)


def test_a_frozen_step_reads_one():
    got = calibrate.readings_for("merton.parity", SEED, ["frozen"],
                                 device="cpu", batch=256)
    assert got["frozen"]["update_gap"] == 1.0
    assert got["frozen"]["grad_gap"] == 1.0


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    out = harness.run(cell, SEED, 0.2, False, BENCH, device="cpu",
                      batch=BATCH, log=lambda *a: None)
    assert out["correct"] is True, out["checks"]
