"""Checkpoints and deterministic resume in the port (utils/checkpointing.py,
``fit``'s ``start_epoch``/``optimizer_state``, the pricing pipeline under
``RunIO(checkpoint_every, resume)``): the round trip of a training state,
the manager's layout and pruning, and a resumed run equal to the uncut run
bit for bit on the CPU (``torch.equal`` on every parameter leaf, the
read-outs equal), with a float learning rate and with the cosine schedule,
and through the pipeline."""

import copy
import dataclasses
import os

import pytest
import torch

from deepfbsdejsolvers_torch.experiments import configs as tc
from deepfbsdejsolvers_torch.experiments.pricing import run_pricing
from deepfbsdejsolvers_torch.models.merton import make_merton_default
from deepfbsdejsolvers_torch.nets.mlp import param_leaves
from deepfbsdejsolvers_torch.solvers.pricing import PricingSolver
from deepfbsdejsolvers_torch.solvers.train import (
    cosine_decay_schedule, fit, make_generator)
from deepfbsdejsolvers_torch.utils.checkpointing import (
    CheckpointManager, restore_checkpoint, save_checkpoint)
from deepfbsdejsolvers_torch.utils.logging import read_jsonl


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_round_trip(tmp_path):
    p = torch.nn.Parameter(torch.randn(3, 4))
    opt = torch.optim.Adam([p], lr=1e-3, eps=1e-7)
    p.grad = torch.ones_like(p)
    opt.step()
    state = {"params": [p.detach(), torch.arange(5)],
             "optimizer": opt.state_dict(), "seed": 7, "epoch": 3,
             "tag": "x"}
    save_checkpoint(str(tmp_path / "c"), state)
    back = restore_checkpoint(str(tmp_path / "c"))
    assert torch.equal(back["params"][0], p.detach())
    assert torch.equal(back["params"][1], torch.arange(5))
    assert (back["seed"], back["epoch"], back["tag"]) == (7, 3, "x")
    opt2 = torch.optim.Adam([torch.nn.Parameter(torch.zeros(3, 4))],
                            lr=1e-3, eps=1e-7)
    opt2.load_state_dict(back["optimizer"])
    s1, s2 = opt.state_dict()["state"][0], opt2.state_dict()["state"][0]
    assert all(torch.equal(s1[k], s2[k]) for k in s1)
    assert os.listdir(tmp_path / "c") == ["state.pt"]


def test_manager_prunes_and_skips_partial_saves(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"), keep=2)
    assert mgr.latest_step() is None and mgr.restore_latest() is None
    for step in range(5):
        mgr.save(step, {"epoch": step, "t": torch.full((2,), float(step))})
    assert sorted(os.listdir(mgr.root)) == ["step_3", "step_4"]
    # a save cut off mid-write leaves only its temporary file: not a
    # checkpoint, so never the latest
    os.makedirs(os.path.join(mgr.root, "step_9"))
    open(os.path.join(mgr.root, "step_9", "state.pt.tmp-1"), "w").close()
    os.makedirs(os.path.join(mgr.root, "step_x"))
    step, state = mgr.restore_latest()
    assert step == 4 and state["epoch"] == 4
    assert torch.equal(state["t"], torch.full((2,), 4.0))


def _tiny_fit(lrate, **kw):
    """Global parity training on a cut Merton model, fresh params from
    seed 0; returns (TrainResult, saved states by epoch)."""
    model = dataclasses.replace(make_merton_default(), N=4)
    solver = PricingSolver(model, "global", hidden=(8, 8), device="cpu")
    params = solver.init_params(make_generator("cpu", 0, 0))
    saved = {}

    def on_epoch(i, metrics, state):
        p, optimizer, seed = state
        saved[i] = {"params": [t.detach().clone()
                               for t in param_leaves(p)],
                    # a copy: Adam updates its moments in place
                    "optimizer": copy.deepcopy(optimizer.state_dict()),
                    "seed": seed}

    if "resume_from" in kw:
        state = kw.pop("resume_from")
        with torch.no_grad():
            for dst, src in zip(param_leaves(params), state["params"]):
                dst.copy_(src)
        kw["optimizer_state"] = state["optimizer"]
    res = fit(loss_fn=solver.build_loss(32), params=params, seed=5,
              lrate=lrate, num_epoch=3, num_epoch_ext=3,
              val_loss_fn=solver.build_loss(64), y0_fn=solver.y0_estimate,
              verbose=False, on_epoch=on_epoch, **kw)
    return res, saved


@pytest.mark.parametrize("schedule", [False, True])
def test_resumed_fit_equals_the_uncut_run(tmp_path, schedule):
    lrate = cosine_decay_schedule(5e-2, 9) if schedule else 5e-2
    uncut, saved = _tiny_fit(lrate)
    # through a file, as a resumed process would read it
    save_checkpoint(str(tmp_path / "s"), saved[1])
    state = restore_checkpoint(str(tmp_path / "s"))
    resumed, _ = _tiny_fit(lrate, resume_from=state, start_epoch=2)
    assert resumed.y0_history == uncut.y0_history[2:]
    assert resumed.loss_history == uncut.loss_history[2:]
    for a, b in zip(param_leaves(resumed.params), param_leaves(uncut.params)):
        assert torch.equal(a, b)
    # the schedule's count carried over: a count restarted at 0 would rerun
    # the peak rate and land elsewhere
    if schedule:
        wrong, _ = _tiny_fit(lrate, resume_from=state)
        assert wrong.y0_history[-1] != uncut.y0_history[-1]


def test_pipeline_resume_through_runio(tmp_path):
    """run 2 outer epochs with a checkpoint each, then resume to 3: the
    third epoch's record and the trained params equal the uncut run's."""
    def run(outdir, epochs, resume=False):
        cfg = tc.MertonConfig(
            n_epoch_ext=epochs, n_epoch=1, batch_size=4, nb_neuron=8,
            methods=("Global",),
            io=tc.RunIO(outdir=str(outdir), checkpoint_every=1,
                        resume=resume))
        return run_pricing(cfg, verbose=False, device="cpu")

    uncut = run(tmp_path / "a", 3)
    run(tmp_path / "b", 2)
    resumed = run(tmp_path / "b", 3, resume=True)
    a, b = uncut.methods["Global"], resumed.methods["Global"]
    assert b.y0_history == a.y0_history[2:]
    assert b.loss_history == a.loss_history[2:]
    for x, y in zip(param_leaves(a.params), param_leaves(b.params)):
        assert torch.equal(x, y)
    last = lambda d: [r for r in read_jsonl(str(d / "metrics.jsonl"))
                      if r.get("epoch") == 2]
    ra, rb = last(tmp_path / "a"), last(tmp_path / "b")
    assert (ra[0]["y0"], ra[0]["loss"]) == (rb[0]["y0"], rb[0]["loss"])
    assert sorted(os.listdir(tmp_path / "b" / "ckpt" / "Global")) == [
        "step_0", "step_1", "step_2"]
