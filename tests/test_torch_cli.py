"""The port's CLI (``python -m deepfbsdejsolvers_torch``) against the JAX
package's: the same subcommands and, for each, the same option strings,
defaults, choices, ``nargs`` and types.  The one allowed difference, named
here: the port's ``--device`` flag on every subcommand.  Also: ``--help``
renders, the sweep's default policy, exit code 2 without a card and on
``--dataParallel``, and ``main`` end to end on the CPU at a tiny size for
each subcommand (the bench's in tests/test_torch_bench.py)."""

import argparse
import os
import subprocess
import sys

import pytest
import torch

from deepfbsdejsolvers_torch.experiments import cli as tcli
from deepfbsdejsolvers_torch.utils.logging import read_jsonl
from deepfbsdejsolvers_tpu.experiments import cli as jcli

SUBCOMMANDS = ("merton", "vg", "mfg-compare", "mfg-poa")
ALL_SUBCOMMANDS = SUBCOMMANDS + ("bench",)
PORT_ONLY_FLAGS = {"--device"}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _subparsers(parser):
    action = next(a for a in parser._actions
                  if isinstance(a, argparse._SubParsersAction))
    return action.choices


def _flags(parser):
    """option string -> (dest, default, choices, nargs, type, action)."""
    out = {}
    for a in parser._actions:
        if isinstance(a, argparse._HelpAction):
            continue
        entry = (a.dest, a.default, a.choices, a.nargs, a.type,
                 type(a).__name__)
        for opt in a.option_strings:
            out[opt] = entry
    return out


def test_subcommands_match_jax_but_bench():
    """Named for the gap it held open until the port's bench came: the
    subcommands are now the JAX CLI's, every one."""
    ours = set(_subparsers(tcli.build_parser()))
    theirs = set(_subparsers(jcli.build_parser()))
    assert ours == set(ALL_SUBCOMMANDS) == theirs


@pytest.mark.parametrize("cmd", ALL_SUBCOMMANDS)
def test_flags_match_jax(cmd):
    ours = _flags(_subparsers(tcli.build_parser())[cmd])
    theirs = _flags(_subparsers(jcli.build_parser())[cmd])
    assert set(ours) - set(theirs) == PORT_ONLY_FLAGS
    assert set(theirs) <= set(ours)
    for opt, entry in theirs.items():
        assert ours[opt] == entry, opt
    assert ours["--device"][:2] == ("device", "cuda")


@pytest.mark.parametrize("argv", [[], *[[c] for c in ALL_SUBCOMMANDS]])
def test_help_renders(argv, capsys):
    with pytest.raises(SystemExit) as exc:
        tcli.build_parser().parse_args([*argv, "--help"])
    assert exc.value.code == 0
    out = capsys.readouterr().out
    assert "usage:" in out
    if argv:
        assert "--device" in out
        assert ("--seed" in out) == (argv != ["bench"])


def test_sweep_default_policy():
    resolve = tcli._resolve_sweep_impl
    assert resolve(None, "cuda") == "pallas"
    assert resolve(None, "cuda:0") == "pallas"
    assert resolve(None, "cuda", hoisted=True) == "xla"
    assert resolve(None, "cpu") == "xla"
    assert resolve("pallas", "cpu") == "pallas"
    assert resolve("xla", "cuda") == "xla"


@pytest.mark.parametrize("cmd", ALL_SUBCOMMANDS)
def test_exit_2_without_a_card(cmd, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tcli.main([cmd]) == 2
    assert "--device cpu" in capsys.readouterr().err


# each subcommand cut to one outer epoch of one step on a few paths
TINY = {
    "merton": ["--nEpochExt", "1", "--nEpoch", "1", "--batchSize", "4",
               "--methods", "Global", "--nbNeuron", "8"],
    "vg": ["--nEpochExt", "1", "--nEpoch", "1", "--batchSize", "4",
           "--methods", "Global", "--nbNeuron", "8"],
    "mfg-compare": ["--nEpochExt", "1", "--nEpoch", "1", "--batchSize", "4",
                    "--methods", "Global", "--nbDays", "1",
                    "--nbSimulation", "0"],
    "mfg-poa": ["--nEpochExt", "1", "--nEpoch", "1", "--batchSize", "4",
                "--nbDays", "1", "--nFrozen", "8", "--piList", "0.1"],
}


@pytest.mark.parametrize("cmd", SUBCOMMANDS)
def test_data_parallel_runs_a_world_of_one(cmd, capsys):
    """Without a launcher ``--dataParallel`` joins a world of one rank
    (gloo on the CPU), trains, and leaves the world when done."""
    import torch.distributed as dist

    assert tcli.main([cmd, "--dataParallel", "--device", "cpu",
                      *TINY[cmd]]) == 0
    assert "data parallel: 1 rank(s), backend gloo" in \
        capsys.readouterr().out
    assert not dist.is_initialized()


def test_module_entry_point_exits_2_without_a_card():
    """``python -m deepfbsdejsolvers_torch`` runs the CLI; this machine has
    no card, so without --device cpu it exits 2."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default run would train")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-m", "deepfbsdejsolvers_torch",
                        "vg"], cwd=repo, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 2, r.stderr
    assert "no CUDA device" in r.stderr


def test_merton_end_to_end_on_the_cpu(tmp_path, capsys):
    out = tmp_path / "m"
    rc = tcli.main(["merton", "--device", "cpu", "--nEpochExt", "1",
                    "--nEpoch", "2", "--batchSize", "8", "--nbNeuron", "8",
                    "--methods", "Global", "SumLocalReg", "--outdir",
                    str(out), "--checkpointEvery", "1", "--quiet"])
    assert rc == 0
    text = capsys.readouterr().out
    assert "Global: Y0=" in text and "closed-form price: 0.271457" in text
    records = read_jsonl(str(out / "metrics.jsonl"))
    assert records[0]["event"] == "start" and records[0]["device"] == "cpu"
    assert {r["sweep_impl"] for r in records if "method" in r} == {"xla"}
    for method in ("Global", "SumLocalReg"):
        assert (out / "ckpt" / method / "step_0" / "state.pt").is_file()


def test_vg_end_to_end_on_the_cpu(tmp_path, capsys):
    rc = tcli.main(["vg", "--device", "cpu", "--nEpochExt", "1", "--nEpoch",
                    "1", "--batchSize", "8", "--nbNeuron", "8", "--methods",
                    "SumMultiStep1", "--sweepImpl", "pallas", "--debugNans",
                    "--outdir", str(tmp_path), "--quiet"])
    assert rc == 0
    assert "FFT reference price: 0.1331" in capsys.readouterr().out
    assert not torch.is_anomaly_enabled()
    # the pure-jump U-net takes the kernels' sweep (its plain version here)
    records = read_jsonl(str(tmp_path / "metrics.jsonl"))
    assert {r["sweep_impl"] for r in records if "method" in r} == {"pallas"}


def test_mfg_compare_end_to_end_on_the_cpu(tmp_path, capsys):
    rc = tcli.main(["mfg-compare", "--device", "cpu", "--nEpochExt", "1",
                    "--nEpoch", "1", "--batchSize", "8", "--nbDays", "1",
                    "--nbNeuron_hat", "8", "--nbNeuron", "8", "--methods",
                    "Global", "--nbSimulation", "16", "--fast", "--outdir",
                    str(tmp_path), "--profileDir", str(tmp_path / "trace"),
                    "--quiet"])
    assert rc == 0
    assert "Global: Y0_hat=" in capsys.readouterr().out
    assert (tmp_path / "Y0List.csv").is_file()
    assert any(p.stat().st_size > 0 for p in (tmp_path / "trace").iterdir())


def test_mfg_poa_end_to_end_on_the_cpu(tmp_path, capsys):
    rc = tcli.main(["mfg-poa", "--device", "cpu", "--nEpochExt", "1",
                    "--nEpoch", "1", "--batchSize", "8", "--nbNeuron_hat",
                    "8", "--nbNeuron", "8", "--nFrozen", "8", "--nReplay",
                    "2", "--piList", "0.1", "--fast", "--outdir",
                    str(tmp_path), "--quiet"])
    assert rc == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].split("  ")[:2] == ["case", "pi"]
    assert len(lines) == 1 + 3          # a row per pricing case
    assert (tmp_path / "poa_table.csv").is_file()
