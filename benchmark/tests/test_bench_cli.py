"""The command's refusals, and (on the card) one short run of each cell."""

import json
import shutil
import subprocess
import sys

import pytest
import torch

from benchmark import harness

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


def _run(root, *args, timeout=600):
    return subprocess.run(
        [sys.executable, str(root / "benchmark" / "run.py"), *args],
        cwd=root, capture_output=True, text=True, timeout=timeout)


def test_an_unknown_cell_is_refused():
    got = _run(harness.ROOT, "--workload", "no.such_cell", "--seed", "1",
               "--seconds", "1", "--trace", "0")
    assert got.returncode == 2 and got.stdout == ""


def test_without_the_program_no_result(tmp_path):
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    got = _run(tmp_path, "--workload", CELLS[0], "--seed", "1",
               "--seconds", "1", "--trace", "0", timeout=300)
    assert got.returncode != 0 and got.stdout == ""


def test_without_a_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is here")
    got = _run(harness.ROOT, "--workload", CELLS[0], "--seed", "1",
               "--seconds", "1", "--trace", "0", timeout=300)
    assert got.returncode == 2 and got.stdout == ""


@pytest.mark.card
@pytest.mark.parametrize("traced", ["0", "1"])
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_on_the_card(cell, traced):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    got = _run(harness.ROOT, "--workload", cell, "--seed", str(2 ** 31 + 3),
               "--seconds", "2", "--trace", traced)
    assert got.returncode == 0, got.stderr[-2000:]
    out = json.loads(got.stdout.strip().splitlines()[-1])
    assert out["correct"] is True, out["checks"]
    assert list(out)[-1] == "checks"
