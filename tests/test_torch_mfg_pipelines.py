"""The port's MFG pipelines end to end on the CPU at a tiny size (the
comparison and the Price-of-Anarchy runs, their CSV, JSONL and figure
artifacts), their configs against the JAX package's, the training loop's
pair read-out and per-epoch hook, couplage ON and OFF, the metrics logger,
and the knob the port refuses."""

import csv
import dataclasses
import json

import numpy as np
import pytest
import torch

from deepfbsdejsolvers_torch.experiments import configs as tc
from deepfbsdejsolvers_torch.experiments.mfg_comparison import (
    run_mfg_comparison)
from deepfbsdejsolvers_torch.experiments.mfg_poa import (
    TABLE_COLUMNS, run_mfg_poa)
from deepfbsdejsolvers_torch.models.mfg_smart_grid import (
    make_mfg_default as torch_mfg)
from deepfbsdejsolvers_torch.nets.mlp import param_leaves
from deepfbsdejsolvers_torch.solvers.mfg import MFGSolver
from deepfbsdejsolvers_torch.solvers.train import fit, make_generator
from deepfbsdejsolvers_torch.utils.logging import (
    JSONLWriter, MetricsLogger, read_jsonl)
from deepfbsdejsolvers_tpu.experiments import configs as jc
from test_torch_mfg_model import tiny

SMALL = dict(hidden_hat=(8, 8), hidden=(8, 8))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_configs_match_jax():
    assert tc.MFG_METHODS == jc.MFG_METHODS
    assert tc.MFG_METHOD_TO_SCHEME == jc.MFG_METHOD_TO_SCHEME
    for ours, theirs in ((tc.MFGComparisonConfig, jc.MFGComparisonConfig),
                         (tc.MFGPoAConfig, jc.MFGPoAConfig)):
        a, b = ours(), theirs()
        fa = {f.name: getattr(a, f.name) for f in dataclasses.fields(a)}
        fb = {f.name: getattr(b, f.name) for f in dataclasses.fields(b)}
        fa.pop("io"), fb.pop("io")
        assert fa == fb
        assert (a.hidden_hat, a.hidden) == (b.hidden_hat, b.hidden)
        for method in tc.MFG_METHODS:
            assert a.lrate_for(method) == b.lrate_for(method), method
    # the reference's crossed mapping
    cfg = tc.MFGComparisonConfig()
    assert cfg.lrate_for("SumMultiStep") == cfg.lrate_reg
    assert cfg.lrate_for("SumLocalReg") == cfg.lrate_loc


def test_configs_take_data_parallel():
    """All four configurations take ``data_parallel=True`` (the pipelines
    run it: tests/test_torch_parallel_pipelines.py), the pricing ones
    beside a ``compute_dtype``."""
    for config in (tc.MFGPoAConfig, tc.MFGComparisonConfig, tc.MertonConfig,
                   tc.VGConfig):
        assert config(data_parallel=True).data_parallel
    for config in (tc.MertonConfig, tc.VGConfig):
        cfg = config(data_parallel=True, compute_dtype="bfloat16")
        assert cfg.data_parallel and cfg.compute_dtype == "bfloat16"


@pytest.mark.parametrize("pipeline", ["mfg-compare", "mfg-poa"])
def test_mfg_pipelines_say_they_ignore_checkpointing(pipeline, tmp_path,
                                                     capsys):
    """The MFG pipelines take checkpoint_every and resume, as the JAX
    package's do, write no checkpoint, and say so on stderr."""
    io = tc.RunIO(outdir=str(tmp_path), checkpoint_every=1, resume=True)
    tiny_run = dict(n_epoch_ext=1, n_epoch=1, batch_size=8, nb_days=1,
                    io=io)
    if pipeline == "mfg-compare":
        run_mfg_comparison(tc.MFGComparisonConfig(
            methods=("Global",), n_simulation=16, **tiny_run),
            verbose=False, device="cpu")
    else:
        run_mfg_poa(tc.MFGPoAConfig(
            n_frozen=8, n_replay=1, pi_list=(0.1,), jump_sampler="icdf",
            cases={"with jumps and with dynamic pricing":
                   (6.159423723, 87.4286117, 0.0, 1e4)}, **tiny_run),
            verbose=False, device="cpu")
    err = capsys.readouterr().err
    assert (f"{pipeline}: checkpoint_every and resume asked for; this "
            "pipeline writes and restores no checkpoint") in err
    assert not (tmp_path / "ckpt").exists()


def test_fit_reads_out_the_pair_and_calls_the_hook():
    solver = MFGSolver(tiny(torch_mfg), "global", device="cpu", **SMALL)
    params = solver.init_params(torch.Generator().manual_seed(0))
    seen = []
    res = fit(loss_fn=solver.build_losses(16)["coupled"], params=params,
              seed=3, lrate=1e-3, num_epoch=2, num_epoch_ext=2,
              y0_fn=solver.y0_estimates, verbose=False,
              on_epoch=lambda k, m, state: seen.append((k, m, state)))
    assert [k for k, _, _ in seen] == [0, 1]
    for _, m, (p, optimizer, seed) in seen:
        assert sorted(m) == ["duration_s", "loss", "y0"]
        assert isinstance(m["y0"], tuple) and len(m["y0"]) == 2
        assert all(isinstance(v, float) for v in m["y0"])
        assert p is params and seed == 3
        assert isinstance(optimizer, torch.optim.Adam)
    assert res.y0_history == [m["y0"] for _, m, _ in seen]


@pytest.mark.parametrize("couplage", ["ON", "OFF"])
def test_training_reduces_the_loss(couplage):
    """Trained params beat the initial ones on the same validation noise;
    with couplage OFF each phase leaves the other net untouched."""
    solver = MFGSolver(tiny(torch_mfg), "global", device="cpu", **SMALL)
    # the nets ``train`` starts from: the CPU generator of (seed, 0)
    params0 = solver.init_params(make_generator("cpu", 0, 0))
    pair_val = solver.build_pair_loss(256)

    def val(p):
        with torch.no_grad():
            return sum(float(x) for x in pair_val(
                p, torch.Generator().manual_seed(7)))

    res = solver.train(0, batch=32, batch_val=128, num_epoch=15,
                       num_epoch_ext=2, lrate=3e-3, couplage=couplage,
                       verbose=False)
    assert val(res.params) < val(params0)
    hat_hist, full_hist = tuple(res)
    assert len(hat_hist) == 2 and len(full_hist) == 2
    assert len(res.loss_history) == (2 if couplage == "ON" else 4)
    if couplage == "OFF":
        assert all(isinstance(v, float) for v in hat_hist + full_hist)
        assert not any(t.requires_grad
                       for t in param_leaves(res.params["hat"]))
        # the full net starts phase 2 at its init: its Y0 moved from there
        assert full_hist[-1] != float(params0["full"]["y0"])


def test_metrics_logger_round_trip(tmp_path):
    path = tmp_path / "m" / "metrics.jsonl"
    log = MetricsLogger(str(path), tags={"experiment": "x"})
    log.child(method="Global").log(epoch=0, loss=torch.tensor(2.5),
                                   y0=(torch.tensor(-1.0), -2.0),
                                   curve=np.arange(3, dtype=np.float32))
    log.close()
    rec = read_jsonl(str(path))
    assert rec[0]["experiment"] == "x" and rec[0]["method"] == "Global"
    assert rec[0]["loss"] == 2.5 and rec[0]["curve"] == [0.0, 1.0, 2.0]
    assert rec[0]["wall_s"] >= 0.0
    with JSONLWriter(str(path)) as w:
        w.write({"t": torch.arange(2)})
    with pytest.raises(ValueError, match="closed"):
        w.write({})
    assert read_jsonl(str(path))[-1] == {"t": [0, 1]}


def test_comparison_pipeline(tmp_path):
    cfg = tc.MFGComparisonConfig(
        n_epoch_ext=1, n_epoch=2, batch_size=16, nb_days=1,
        methods=("Global", "SumLocal"), n_simulation=32,
        io=tc.RunIO(outdir=str(tmp_path), save_plots=True))
    res = run_mfg_comparison(cfg, verbose=False, device="cpu")
    assert res.model.N == 47
    for m in cfg.methods:
        r = res.methods[m]
        assert np.isfinite(r.y0_history[-1]) and np.isfinite(r.eval_cost)
        assert r.eval_ci >= 0.0
    hist = np.loadtxt(tmp_path / "Y0List.csv", delimiter=",")
    assert hist.shape == (2,)
    assert (tmp_path / "hY0List.csv").exists()
    assert (tmp_path / "mfg_convergence.png").exists()
    events = [r.get("event") for r in read_jsonl(
        str(tmp_path / "metrics.jsonl"))]
    assert events.count("method_done") == 2
    assert events.count("frozen_eval") == 2
    assert events.count(None) == 2          # one epoch record per method


def test_poa_pipeline(tmp_path):
    cfg = tc.MFGPoAConfig(
        n_epoch_ext=1, n_epoch=2, batch_size=16, nb_days=1,
        n_frozen=16, n_replay=2, pi_list=(0.1,), jump_sampler="icdf",
        cases={"with jumps and with dynamic pricing":
               (6.159423723, 87.4286117, 0.0, 1e4)},
        io=tc.RunIO(outdir=str(tmp_path), save_plots=True))
    res = run_mfg_poa(cfg, verbose=False, device="cpu")
    assert len(res.cells) == 1
    cell = res.cells[0]
    assert np.isfinite(cell.poa) and cell.poa > 0
    assert sorted(cell.evaluators) == ["mfc_p1", "mfc_p2", "mfg_p1",
                                       "mfg_p2"]
    table = res.table()
    assert [r["pi"] for r in table] == [0.1]
    assert list(table[0]) == list(TABLE_COLUMNS)
    with open(tmp_path / "poa_table.csv") as fh:
        rows = list(csv.DictReader(fh))
    assert list(rows[0]) == list(TABLE_COLUMNS)
    assert float(rows[0]["PoA"]) == pytest.approx(cell.poa)
    assert (tmp_path / "simulations_all_cases.pdf").exists()
    rec = [json.loads(line) for line in open(tmp_path / "metrics.jsonl")]
    assert rec[-1]["event"] == "cell_done" and rec[-1]["poa"] == cell.poa
