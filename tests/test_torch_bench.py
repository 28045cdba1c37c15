"""The port's bench (``experiments/bench.py`` and the CLI's ``bench``
subcommand) against the JAX package's ``bench.py``: the same flags (the
module's parser is bench.py's own, taken from its ``main``; the
subcommand's is the JAX CLI's, in tests/test_torch_cli.py), plus
``--device``; for every cell ``build`` makes a solver whose fields, and
whose model's, equal those of bench.py's ``build`` (bench.py is imported,
never run); the one-line JSON on the CPU at a tiny size, with bench.py's
keys and metric names; and exit status 2 for what the port refuses."""

import argparse
import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch

from deepfbsdejsolvers_torch.experiments import bench as tbench
from deepfbsdejsolvers_torch.experiments import cli as tcli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import bench as jbench  # noqa: E402  (the JAX package's bench.py)

JSON_KEYS = ["metric", "value", "unit", "vs_baseline"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


class _Parsed(Exception):
    pass


def jax_bench_parser(monkeypatch):
    """bench.py's parser, as its ``main`` builds it (it stops there)."""
    seen = {}

    def capture(self, args=None, namespace=None):
        seen["parser"] = self
        raise _Parsed

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(_Parsed):
        jbench.main()
    monkeypatch.undo()
    return seen["parser"]


def _flags(parser):
    """option string -> (dest, default, choices, nargs, type, action)."""
    out = {}
    for a in parser._actions:
        if isinstance(a, argparse._HelpAction):
            continue
        for opt in a.option_strings:
            out[opt] = (a.dest, a.default, a.choices, a.nargs, a.type,
                        type(a).__name__)
    return out


def test_module_flags_are_bench_py_flags_plus_device(monkeypatch):
    ours = _flags(tbench.build_parser())
    theirs = _flags(jax_bench_parser(monkeypatch))
    assert set(ours) - set(theirs) == {"--device"}
    assert set(theirs) <= set(ours)
    for opt, entry in theirs.items():
        assert ours[opt] == entry, opt
    assert ours["--device"][:2] == ("device", "cuda")
    for opt in ("--scheme", "--adjoint", "--anchor"):
        assert opt in theirs


def test_bench_py_help_names_the_same_options():
    """``python bench.py --help`` (it exits in its parser, before any JAX
    import) lists every option the module takes but ``--device``."""
    r = subprocess.run([sys.executable, os.path.join(REPO, "bench.py"),
                        "--help"], capture_output=True, text=True,
                       timeout=120, cwd=REPO)
    assert r.returncode == 0, r.stderr
    for opt in _flags(tbench.build_parser()):
        assert (opt in r.stdout) == (opt != "--device"), opt
    for choice in tbench.SCHEMES:
        assert choice in r.stdout


def test_subcommand_flags_are_the_jax_clis(monkeypatch):
    from deepfbsdejsolvers_tpu.experiments import cli as jcli

    def sub(parser):
        action = next(a for a in parser._actions
                      if isinstance(a, argparse._SubParsersAction))
        return _flags(action.choices["bench"])

    ours, theirs = sub(tcli.build_parser()), sub(jcli.build_parser())
    assert set(ours) - set(theirs) == {"--device"}
    assert all(ours[k] == v for k, v in theirs.items())


def _simple(obj):
    """The plain-valued dataclass fields of ``obj`` (callables and tables
    dropped), nested dataclasses as dicts."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            out[f.name] = _simple(v)
        elif v is None or isinstance(v, (bool, int, float, str, tuple)):
            out[f.name] = v
    return out


def _assert_same_fields(ours, theirs, skip=("model", "device")):
    a, b = _simple(ours), _simple(theirs)
    common = (set(a) & set(b)) - set(skip)
    assert common, (a, b)
    for k in sorted(common):
        assert a[k] == b[k], (k, a[k], b[k])
    # the port's fields are the JAX package's, but for the device and the
    # JAX-only precision knobs of its TPU kernels
    assert set(a) - set(b) <= {"device"}


CELLS = [
    # (model, parity, compensator, sweep, fused, scheme)
    ("merton", False, "quadrature", None, False, "global"),
    ("merton", False, "quadrature", None, True, "global"),
    ("merton", False, "mc", None, False, "global"),
    ("merton", False, "quadrature", "pallas", False, "global"),
    ("merton", False, "quadrature", None, False, "sumlocal2"),
    ("merton", True, "quadrature", None, False, "global"),
    ("merton", True, "mc", None, False, "global"),
    ("merton", True, "quadrature", "pallas", False, "global"),
    ("merton", True, "quadrature", None, False, "multistep1"),
    ("vg", False, "quadrature", None, False, "global"),
    ("vg", True, "quadrature", None, False, "global"),
    ("vg", True, "mc", None, False, "multistep_reg"),
    ("mfg", False, "quadrature", None, False, "global"),
    ("mfg", True, "quadrature", None, False, "global"),
]


@pytest.mark.parametrize("cell", CELLS, ids=lambda c: "-".join(map(str, c)))
def test_build_matches_bench_py(cell):
    """The same solver and model fields as bench.py's ``build`` on the CPU
    (where its parity sweep also defaults to "xla"), and the same Adam
    rate."""
    model, parity, comp, sweep, fused, scheme = cell
    jm, js, *_ = jbench.build(64, comp, parity, model, sweep, False, fused,
                              None, scheme)
    tm, ts, params, opt, loss_fn = tbench.build(
        64, comp, parity, model, sweep, fused, scheme, device="cpu")
    _assert_same_fields(ts, js)
    _assert_same_fields(tm, jm, skip=())
    assert type(ts).__name__ == type(js).__name__
    assert opt.param_groups[0]["lr"] == (1e-3 if model == "mfg" else 4e-4)
    assert callable(loss_fn)


def test_cpu_parity_sweep_defaults_to_the_plain_sweep():
    """On the CPU the parity sweep defaults to the plain sweep, as bench.py's
    does off a TPU (on the card to the kernels B3/B4, which chip_smoke.py's
    bench phase holds to their launch counts)."""
    assert tbench.build(8, "quadrature", True, device="cpu")[1].sweep_impl \
        == "xla"


def _run_main(capsys, argv):
    rc = tbench.main(argv)
    out, err = capsys.readouterr()
    return rc, out, err


@pytest.mark.parametrize("argv,metric", [
    ([], "merton_global_train_throughput"),
    (["--fused"], "merton_global_train_throughput"),
    (["--parity", "--scheme", "sumlocal_reg"],
     "merton_sumlocal_reg_train_throughput"),
])
def test_main_prints_bench_py_json_line(capsys, argv, metric):
    rc, out, err = _run_main(capsys, ["--device", "cpu", "--batch", "64",
                                      "--inner", "2", "--rounds", "1",
                                      *argv])
    assert rc == 0
    lines = out.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert list(rec) == JSON_KEYS
    assert rec["metric"] == metric
    assert rec["value"] > 0
    assert rec["unit"] == "paths*steps/sec/chip (merton N=50, batch 2^6)"
    anchor = json.load(open(os.path.join(REPO, "bench_baseline.json")))
    if "--scheme" in argv:
        assert rec["vs_baseline"] is None
    else:
        assert rec["vs_baseline"] == pytest.approx(
            rec["value"] / anchor["anchor_paths_steps_per_sec"])
    assert err.startswith("# detail: {") and "'device': 'cpu'" in err
    assert "'round_seconds': [" in err and "'final_loss': " in err


def test_the_cli_subcommand_runs_the_bench_in_process(capsys):
    rc = tcli.main(["bench", "--device", "cpu", "--model", "mfg", "--batch",
                    "8", "--inner", "1", "--rounds", "1"])
    assert rc == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["metric"] == "mfg_global_train_throughput"
    assert rec["unit"] == "paths*steps/sec/chip (mfg N=96, batch 2^3)"
    assert rec["vs_baseline"] is None


@pytest.mark.parametrize("argv,why", [
    (["--anchor"], "bench_baseline.json"),
])
def test_refused_options_exit_2(capsys, argv, why):
    rc, out, err = _run_main(capsys, [*argv, "--device", "cpu"])
    assert rc == 2 and out == "" and why in err


CUT = ["--device", "cpu", "--batch", "64", "--inner", "1", "--rounds", "1"]


@pytest.mark.parametrize("argv,rng", [
    (["--adjoint"], "threefry"),
    (["--rng", "rbg"], "rbg"),
    (["--fused", "--fusedPrecision", "default"], "threefry"),
])
def test_opt_in_options_run(capsys, argv, rng):
    """``--adjoint``, ``--rng rbg`` and ``--fusedPrecision default`` run the
    Merton speed cell; the detail record names the rng asked for and the
    generator drawn from."""
    rc, out, err = _run_main(capsys, [*argv, *CUT])
    assert rc == 0
    rec = json.loads(out.strip().splitlines()[-1])
    assert list(rec) == JSON_KEYS and rec["value"] > 0
    assert f"'rng': '{rng}'" in err and "'generator': 'mt19937'" in err


@pytest.mark.parametrize("argv", [["--rng", "rbg"],
                                  ["--fused", "--fusedPrecision", "default"]])
def test_subcommand_takes_opt_in_options(capsys, argv):
    assert tcli.main(["bench", *argv, *CUT]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["metric"] == "merton_global_train_throughput"


def test_adjoint_usage_errors():
    for argv in (["--adjoint", "--parity"], ["--adjoint", "--model", "vg"],
                 ["--adjoint", "--scheme", "sumlocal2"]):
        with pytest.raises(SystemExit) as exc:
            tbench.main([*argv, "--device", "cpu"])
        assert exc.value.code == 2


@pytest.mark.parametrize("argv,why", [
    (["--fused", "--parity"], "--fused applies only"),
    (["--model", "vg", "--sweep", "pallas"], "--sweep applies only"),
])
def test_subcommand_refusals_exit_2(capsys, argv, why):
    assert tcli.main(["bench", *argv, "--device", "cpu"]) == 2
    assert why in capsys.readouterr().err


@pytest.mark.parametrize("argv", [["--fused", "--parity"],
                                  ["--fusedPrecision", "highest"],
                                  ["--model", "mfg", "--scheme", "sumlocal1"],
                                  ["--fused", "--scheme", "multistep2"]])
def test_usage_errors_exit_2(argv):
    with pytest.raises(SystemExit) as exc:
        tbench.main([*argv, "--device", "cpu"])
    assert exc.value.code == 2


def test_without_a_card_exit_2(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc, out, err = _run_main(capsys, [])
    assert rc == 2 and out == "" and "--device cpu" in err
