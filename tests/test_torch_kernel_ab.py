"""kernel_ab.py's report and exit code, on the CPU: the SASS loop parser,
the pairing of kernels across builds by name, width and instance, and an
exit code that says whether every build passed every check."""

import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import kernel_ab as K  # noqa: E402

# B1's FP32 instance at H = 21 as mangled, with a third template argument,
# and a kernel without template arguments
B1 = "_ZN7rollout10fwd_kernelILi21ELb0EEEvPKfS2_S2_S2_S2_S2_S2_S2_S2_S2_"
B1_THIRD = "_ZN7rollout10fwd_kernelILi21ELb0ELi2EEEvPKfS2_S2_S2_S2_S2_S2_"
REDUCE = "_ZN7rollout15reduce_partialsEPKfPfii"


@pytest.mark.parametrize("mangled,key", [
    (B1, "fwd_kernel<21,false>"), (B1_THIRD, "fwd_kernel<21,false>"),
    ("_ZN7rollout10bwd_kernelILi8ELb1EEEvPKf", "bwd_kernel<8,true>"),
    ("_ZN12rollout_wide10fwd_kernelILi128ELb1EEEvPKf",
     "fwd_kernel<128,true>"),
    (REDUCE, "reduce_partials")])
def test_sass_key_pairs_kernels_by_name_width_and_instance(mangled, key):
    assert K.sass_key(mangled) == key


def _instrs():
    """A body of 12 instructions with a loop (0x20-0x70) around an inner
    loop (0x40-0x50): (address, opcode, branch target)."""
    ops = ["MOV", "LDG", "FFMA", "LDS", "FFMA", "BRA", "MUFU", "BRA",
           "STG", "EXIT", "BRA", "NOP"]
    targets = {5: 0x40, 7: 0x20, 10: 0xa0}
    return [(16 * i, op, targets.get(i)) for i, op in enumerate(ops)]


def test_loops_count_each_body_without_its_inner_loops():
    found = K.loops(_instrs())
    assert [(d, s, e) for d, s, e, _ in found] == [
        (0, 0x20, 0x70), (1, 0x40, 0x50), (0, 0xa0, 0xa0)]
    outer, inner, tail = (c for *_, c in found)
    assert outer == {"all": 4, "fp32": 1, "lds": 1, "mufu": 1}
    assert inner == {"all": 2, "fp32": 1}
    assert tail == {"all": 1}
    assert K.counts(_instrs())["all"] == 12


def test_compare_sass_says_which_kernels_moved(capsys):
    same = (K.counts(_instrs()), [(0, {"all": 4})])
    moved = (same[0], [(0, {"all": 5})])
    K.compare_sass({"base": {("rollout_fwd", "fwd_kernel<21,false>"): same},
                    "this": {("rollout_fwd", "fwd_kernel<21,false>"): moved,
                             ("rollout_fwd", "fwd_kernel<8,true>"): same}})
    out = capsys.readouterr().out.splitlines()
    assert ("base sass rollout_fwd fwd_kernel<21,false>: whole counts equal "
            "to base's: True; loop counts: True") in out
    assert ("this sass rollout_fwd fwd_kernel<21,false>: whole counts equal "
            "to base's: True; loop counts: False") in out
    assert ("this sass rollout_fwd fwd_kernel<8,true>: whole counts equal "
            "to base's: False; loop counts: False") in out


def test_another_builds_failed_check_sets_the_exit_code(monkeypatch):
    """Another build's failed check is recorded and the run goes on; the
    verdict is 1.  This checkout's failure ends the run."""
    monkeypatch.setattr(K, "FAILED", [])

    def fails():
        raise SystemExit(1)

    assert K.verdict() == 0
    assert K.checked("base", lambda: "ok") == "ok"
    assert K.checked("base", fails) is None
    assert K.FAILED == ["base"]
    assert K.verdict() == 1
    with pytest.raises(SystemExit):
        K.checked("this", fails)


def test_exits_2_without_a_card():
    r = subprocess.run([sys.executable, str(REPO / "kernel_ab.py")],
                       cwd=REPO, capture_output=True, text=True, timeout=300)
    assert r.returncode == 2
    assert "no CUDA device" in r.stderr
