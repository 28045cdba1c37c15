"""The data-parallel entry points of the port on gloo ranks on the CPU:
MFG training on a mesh (couplage ON and OFF), ``mfg-poa --dataParallel``
end to end through the CLI (the JAX package's
tests/test_experiments.py::test_mfg_poa_pipeline_data_parallel), a resumed
data-parallel pricing run against the uncut one bit for bit (its
tests/test_checkpoint.py::test_resume_is_deterministic_under_mesh), the
dry run at four ranks, and a rank that fails or hangs failing the run.
The ranks run the functions of tests/torch_parallel_ranks.py."""

import csv
import json
import os

import numpy as np
import pytest

import torch_parallel_ranks as tr
from deepfbsdejsolvers_torch.experiments import dryrun_multichip
from deepfbsdejsolvers_torch.parallel.launch import run_ranks


@pytest.mark.parametrize("couplage", ["ON", "OFF"])
def test_mfg_train_on_a_mesh(couplage):
    """Both phases train on the mesh when couplage is OFF; every rank ends
    with the same params and the same histories, all finite."""
    ranks = run_ranks(tr.mfg_mesh_train, 2, couplage, device="cpu",
                      timeout=300)
    a, b = ranks
    assert a == b
    n = 2 if couplage == "ON" else 4
    assert len(a["loss"]) == n and np.all(np.isfinite(a["loss"]))
    assert np.all(np.isfinite(a["y0_hat"])) and np.all(np.isfinite(a["y0"]))


def test_mfg_poa_data_parallel_end_to_end(tmp_path):
    """Coupled training, frozen replays and the PoA table on two ranks;
    rank 0 alone writes, so each record and row appears once."""
    argv = ["mfg-poa", "--dataParallel", "--device", "cpu", "--quiet",
            "--nEpochExt", "1", "--nEpoch", "2", "--batchSize", "16",
            "--nbDays", "1", "--nFrozen", "16", "--nReplay", "2",
            "--piList", "0.1", "--outdir", str(tmp_path)]
    assert run_ranks(tr.cli_rank, 2, [argv], device="cpu",
                     timeout=300) == [[0], [0]]
    with open(tmp_path / "poa_table.csv") as fh:
        rows = list(csv.DictReader(fh))
    assert len(rows) == 3
    assert all(np.isfinite(float(r["PoA"])) for r in rows)
    with open(tmp_path / "metrics.jsonl") as fh:
        records = [json.loads(line) for line in fh]
    assert [r.get("event") for r in records].count("cell_done") == 3


def test_resumed_data_parallel_run_equals_the_uncut_one(tmp_path):
    """3 outer epochs uncut against 2 then ``resume`` to 3, on two ranks:
    the third epoch's Y0 and loss and the params bit for bit, the same on
    both ranks; each epoch's record written once."""
    ranks = run_ranks(tr.pricing_resume, 2, str(tmp_path), device="cpu",
                      timeout=300)
    for r in ranks:
        uncut, resumed = r["uncut"], r["resumed"]
        assert resumed["y0"] == uncut["y0"][2:]
        assert resumed["loss"] == uncut["loss"][2:]
        assert resumed["digest"] == uncut["digest"]
    assert ({r[k]["digest"] for r in ranks for k in ("uncut", "resumed")}
            == {ranks[0]["uncut"]["digest"]})
    with open(tmp_path / "uncut" / "metrics.jsonl") as fh:
        epochs = [json.loads(line).get("epoch") for line in fh]
    assert sorted(e for e in epochs if e is not None) == [0, 1, 2]
    assert sorted(os.listdir(tmp_path / "uncut" / "ckpt" / "Global")) == [
        "step_0", "step_1", "step_2"]


def test_dry_run_at_four_ranks(capsys):
    assert dryrun_multichip.main(["--ranks", "4", "--device", "cpu"]) == 0
    assert "dryrun_multichip OK: 4 ranks" in capsys.readouterr().out


@pytest.mark.parametrize("fn", [tr.raise_on_rank_one, tr.hang_on_rank_one])
def test_a_rank_that_fails_or_hangs_fails_the_run(fn):
    with pytest.raises(RuntimeError, match="rank|timed out"):
        run_ranks(fn, 2, device="cpu", timeout=10)
