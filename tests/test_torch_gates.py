"""CPU tier of the port's accuracy-gate runner
(``deepfbsdejsolvers_torch.experiments.convergence_gates``).

The registry holds the JAX package's ten Merton, five Variance-Gamma and
six MFG gate rows with the same configuration and budget keys; the first
tests hold them, and the smoke budgets below, against the JAX gate script
and its smoke tier (tests/test_gates_smoke.py).  Then every row trains end to end through
``run_entry`` at that tier's budget (300 cosine-decayed Adam steps, batch
256, one seed) and must read out finite and within 5e-2 of the oracle: a
broken path, a diverging loss or a mis-built table fails, while the real
1e-3 gates run on the card.  The MFG rows train at that tier's MFG budget
(120 steps at batch 128, warm start at 2048 paths; the consensus row 60
steps, its costs on 1024 paths) and are checked as it checks them: an
``mfg_lq_*`` row's relative error must be finite and at least 0.05 below
the cold start's 1, the consensus row's spreads finite.  Each row trains in the file that
``GATE_FILES`` names (that file's ``GATES``), so that no file trains for
long on one worker.

Five rows train for fewer steps than that tier gives them, because the
port's eager loop on the CPU costs ~4.7 ms per time step at batch 256.  Four
are warm-started: ``merton_coupled_direct`` (N = 1600, ~7.5 s a step) 8
steps where the JAX tier takes 60, ``vg_coupled_direct`` (N = 240, hidden
(64, 64), ~4.4 s a step: 265 s for the JAX tier's 60 steps) 12, and the
two extrapolated rows (two fits per seed) 150 where it takes 300 (the VG
row's file took 117 s at 300).  All four start Y0 at the Monte-Carlo
estimate of the price, so what they check is that training does not
diverge, as in the JAX tier; at a peak rate of 3e-3, 12 Adam steps move
Y0 by at most 0.036, inside the 5e-2 check.  ``merton_direct`` (multistep1 sweeping its
U-net over 49 nodes at every path, ~0.4 s a step on one CPU thread) trains
150 steps where the JAX tier takes 300: on one CPU thread its read-out
sat 1.85e-2 from the oracle after 150 steps and 2.05e-2 after 300, so
the 5e-2 check keeps its margin.
"""

import dataclasses
import functools
import importlib
import json

import numpy as np
import pytest
import torch

from deepfbsdejsolvers_torch.experiments import convergence_gates as cg
from deepfbsdejsolvers_torch.ops.compensator import CompensatorSpec
from test_gates_smoke import _BUDGET as JAX_BUDGET
from test_gates_smoke import _load_cg, _per_gate

pytestmark = pytest.mark.gates

BUDGET = dict(steps=300, seeds=1, batch=256, tail=4)
PER_GATE = {
    "merton_coupled_direct": dict(steps=8),
    "vg_coupled_direct": dict(steps=12),
    "vg_global_extrapolated": dict(steps=150),
    "merton_global_extrapolated": dict(steps=150),
    "merton_direct": dict(steps=150),
    "merton_speed_mc": dict(
        steps=60, compensator=CompensatorSpec(kind="mc", n_mc=500,
                                              x_interp="chebyshev",
                                              n_cheb=64)),
    **{f"mfg_lq_{scheme}": dict(steps=120, batch=128, seeds=1,
                                warm_batch=2048)
       for scheme in ("global", "multistep", "sumlocal", "sumlocal_reg",
                      "multistep_reg")},
    "mfg_consensus": dict(steps=60, batch=128, cost_batch=1024, seeds=1,
                          warm_batch=2048),
}
# the rows trained for fewer steps than in the JAX tier (module docstring)
TRIMMED = ("merton_coupled_direct", "merton_global_extrapolated",
           "merton_direct", "vg_coupled_direct", "vg_global_extrapolated")

GATE_FILES = {
    "merton_speed": "test_torch_gates.py",
    "merton_speed_fused": "test_torch_gates_fused.py",
    "merton_speed_mc": "test_torch_gates_mc.py",
    "merton_multistep_diag": "test_torch_gates_multistep.py",
    "merton_coupled_diag": "test_torch_gates_coupled.py",
    "merton_coupled_direct": "test_torch_gates_fine.py",
    "merton_direct": "test_torch_gates_direct.py",
    "merton_cheb": "test_torch_gates_cheb.py",
    "merton_global": "test_torch_gates_global.py",
    "merton_global_extrapolated": "test_torch_gates_extrapolated.py",
    "vg_coupled_direct": "test_torch_gates_vg_coupled.py",
    "vg_direct": "test_torch_gates_vg_direct.py",
    "vg_speed": "test_torch_gates_vg_speed.py",
    "vg_half_coupling": "test_torch_gates_vg_half.py",
    "vg_global_extrapolated": "test_torch_gates_vg_extrapolated.py",
    "mfg_lq_global": "test_torch_gates_mfg_global.py",
    "mfg_lq_multistep": "test_torch_gates_mfg_multistep.py",
    "mfg_lq_multistep_reg": "test_torch_gates_mfg_multistep_reg.py",
    "mfg_lq_sumlocal": "test_torch_gates_mfg_sumlocal.py",
    "mfg_lq_sumlocal_reg": "test_torch_gates_mfg_sumlocal_reg.py",
    "mfg_consensus": "test_torch_gates_mfg_consensus.py",
}
GATES = ["merton_speed"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Train on one CPU thread: the eager loop's tensors are small, so more
    threads only spin, and the tier runs a process on each core."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@functools.lru_cache(maxsize=None)
def port_registry():
    return cg.build_registry()


def check_gate(name: str) -> None:
    """Train the row ``name`` on the CPU at its smoke budget."""
    entry = port_registry()[name]
    record = cg.run_entry(name, entry, device="cpu",
                          **{**BUDGET, **PER_GATE.get(name, {})})
    assert record["device"] == "cpu" and record["seconds"] > 0
    if entry["kind"] == "mfg_consensus":
        # does the path run: both schemes trained, the costs finite
        assert np.isfinite(record["y0_hat_spread"]), (name, record)
        assert np.isfinite(record["cost_hat_spread"]), (name, record)
        return
    if entry["kind"] == "mfg_lq":
        # progress from the cold nets' ~0 toward the −48.3 oracle
        err = record["rel_error"]
        assert np.isfinite(err), (name, record)
        assert err < record["init_rel_error"] - 0.05, (name, record)
        return
    err = record["abs_error"]
    assert np.isfinite(err), (name, record)
    assert err < 5e-2, (name, record)


@pytest.fixture(scope="module")
def jax_cg():
    return _load_cg()


def _fields(obj) -> dict:
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


# the fields only the JAX models have: none since the port's Merton model
# took the "table" price mode's
JAX_ONLY_FIELDS = {"MertonJumpModel": set(), "VGModel": set()}


def _assert_same_model(ours, theirs):
    """Every field the port's model has equals the JAX model's; the fields
    only the JAX model has (``JAX_ONLY_FIELDS``) sit at their defaults;
    the couplings agree on a grid."""
    assert type(ours).__name__ == type(theirs).__name__
    mine, jax_side = _fields(ours), _fields(theirs)
    extra = set(jax_side) - set(mine)
    assert extra == JAX_ONLY_FIELDS[type(theirs).__name__], extra
    for name in extra:
        default = next(f.default for f in dataclasses.fields(theirs)
                       if f.name == name)
        assert jax_side[name] == default, name
    u = np.linspace(-2.0, 2.0, 9).astype(np.float32)
    np.testing.assert_allclose(
        np.asarray(mine.pop("coupling")(torch.tensor(u))),
        np.asarray(jax_side.pop("coupling")(u)), rtol=1e-6)
    assert mine == {k: jax_side[k] for k in mine}


def _assert_same_args(ours, theirs):
    assert sorted(ours) == sorted(theirs)
    for key, want in theirs.items():
        got = ours[key]
        if key == "model":
            _assert_same_model(got, want)
        elif key == "compensator":
            assert _fields(got) == _fields(want)
        elif key == "oracle":
            assert got == pytest.approx(want, rel=1e-6)
        elif key == "make_model":
            for a in (0.05, 0.1):
                _assert_same_model(got(a), want(a))
        else:
            assert got == want, key


def _assert_rows_match(prefix, jax_cg):
    """The registry's rows named ``prefix``… equal the JAX script's."""
    theirs = {k: v for k, v in jax_cg.build_registry().items()
              if k.startswith(prefix)}
    ours = {k: v for k, v in port_registry().items() if k.startswith(prefix)}
    assert sorted(ours) == sorted(theirs) == sorted(
        g for g in GATE_FILES if g.startswith(prefix))
    for name, entry in theirs.items():
        assert ours[name]["kind"] == entry["kind"], name
        _assert_same_args(ours[name]["args"], entry["args"])
    return ours


def test_merton_rows_match_the_jax_registry(jax_cg):
    ours = _assert_rows_match("merton", jax_cg)
    assert ours["merton_speed"]["args"]["oracle"] == pytest.approx(
        0.271457, abs=1e-6)
    assert sorted(port_registry()) == sorted(GATE_FILES)


def test_vg_rows_match_the_jax_registry(jax_cg):
    ours = _assert_rows_match("vg", jax_cg)
    assert ours["vg_speed"]["args"]["oracle"] == pytest.approx(
        0.133141, abs=2e-6)


def test_mfg_rows_match_the_jax_registry(jax_cg):
    """The six MFG rows: the same kinds and keys, every model field equal
    (the profile array for array), the LQ oracle beside the port's."""
    theirs = {k: v for k, v in jax_cg.build_registry().items()
              if k.startswith("mfg")}
    ours = {k: v for k, v in port_registry().items() if k.startswith("mfg")}
    assert sorted(ours) == sorted(theirs) == sorted(
        g for g in GATE_FILES if g.startswith("mfg"))
    for name, entry in theirs.items():
        assert ours[name]["kind"] == entry["kind"], name
        mine, want = dict(ours[name]["args"]), dict(entry["args"])
        a, b = _fields(mine.pop("model")), _fields(want.pop("model"))
        np.testing.assert_array_equal(a.pop("q_aver"), b.pop("q_aver"))
        assert a == b, name
        assert mine == want, name
    oracle = cg.solve_lq(ours["mfg_lq_global"]["args"]["model"])
    assert oracle.y0_hat == pytest.approx(-48.320138, abs=1e-6)


def test_smoke_budgets_follow_the_jax_tier(jax_cg):
    assert BUDGET == JAX_BUDGET
    theirs = _per_gate(jax_cg)
    for name in GATE_FILES:
        ours, want = PER_GATE.get(name, {}), theirs.get(name, {})
        if name in TRIMMED:
            assert ours["steps"] < want.get("steps", BUDGET["steps"])
            continue
        assert sorted(ours) == sorted(want), name
        for key, value in want.items():
            got = ours[key]
            if key == "compensator":
                assert _fields(got) == _fields(value)
            else:
                assert got == value, (name, key)


def test_main_refuses_cuda_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    assert cg.main(["merton_speed"]) == 2
    assert "no CUDA device" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        cg.main(["no_such_gate", "--device", "cpu"])


def test_main_trains_only_the_seeds_named(monkeypatch, capsys):
    runs = []

    def fit_y0(solver, seed, *args):
        runs.append(seed)
        return 0.271457 + 1e-4 * seed

    def fit_mfg(solver, seed, *args):
        runs.append(seed)
        return -48.3201 - 0.1 * seed, -48.3201, None

    monkeypatch.setattr(cg, "_fit_y0", fit_y0)
    monkeypatch.setattr(cg, "_fit_mfg", fit_mfg)
    assert cg.main(["merton_speed", "--device", "cpu", "--seed", "2",
                    "--seed", "0"]) == 0
    assert runs == [2, 0]
    record = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert record["seeds"] == [2, 0]
    assert record["y0"] == pytest.approx([0.271657, 0.271457])
    # an MFG row passes or fails on its own relative bar (multistep 2.5e-2)
    assert cg.main(["mfg_lq_multistep", "--device", "cpu", "--seed",
                    "1"]) == 0
    assert cg.main(["mfg_lq_global", "--device", "cpu", "--seed", "1"]) == 1
    records = [json.loads(line) for line in
               capsys.readouterr().out.strip().splitlines()]
    assert [r["seeds"] for r in records] == [[1], [1]]
    assert records[0]["pass_0.025"] and not records[1]["pass_0.001"]
    assert records[1]["y0_pairs"] == [pytest.approx([-48.4201, -48.3201])]


def test_every_row_trains_in_its_file():
    for name in GATE_FILES.values():
        rows = [g for g, f in GATE_FILES.items() if f == name]
        assert importlib.import_module(name[:-3]).GATES == rows, name


@pytest.mark.parametrize("name", GATES)
def test_gate_config_trains(name):
    check_gate(name)
