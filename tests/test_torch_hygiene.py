"""The port stands alone: it imports neither JAX nor the JAX package, its
kernel builder imports on a machine without nvcc, and chip_smoke.py refuses
to run without a card or without the package beside it."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "deepfbsdejsolvers_torch"

IMPORT_ALL = """
import importlib, pkgutil, sys
import deepfbsdejsolvers_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = [m for m in sys.modules
       if m == "jax" or m.startswith(("jax.", "deepfbsdejsolvers_tpu"))]
assert not bad, bad
assert "deepfbsdejsolvers_torch.ops._build" in sys.modules
print(" ".join(names))
"""


def _run(args, cwd, env=None):
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_importing_every_module_loads_no_jax():
    env = dict(os.environ, PATH=os.path.dirname(sys.executable))
    env.pop("CUDA_HOME", None)
    r = _run(["-c", IMPORT_ALL], REPO, env)
    assert r.returncode == 0, r.stderr
    names = set(r.stdout.split())
    assert len(names) >= 18
    assert {f"deepfbsdejsolvers_torch.{m}" for m in (
        "models.variance_gamma", "ops.interp",
        "experiments.vg_moment_probe", "models.mfg_smart_grid",
        "solvers.mfg", "eval.mfg_lq_oracle", "eval.mfg_solutions",
        "experiments.configs", "experiments.mfg_comparison",
        "experiments.mfg_poa", "utils.logging", "experiments.pricing",
        "experiments.cli", "utils.checkpointing", "utils.profiling",
        "utils.debug", "experiments.bench", "__main__",
        "parallel.data_parallel", "parallel.launch",
        "experiments.dryrun_multichip")} <= names


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(REPO)) for p in [*PKG.rglob("*.py"), *PKG.rglob("*.cu*"),
                                       REPO / "chip_smoke.py",
                                       REPO / "kernel_ab.py",
                                       REPO / "step_probe.py"]))
def test_no_source_names_jax(path):
    """chip_smoke.py may name the TPU kernels it reports on, never import
    them."""
    words = ["import jax", "from jax", "import deepfbsdejsolvers_tpu",
             "from deepfbsdejsolvers_tpu"]
    if path != "chip_smoke.py":
        words.append("deepfbsdejsolvers_tpu")
    text = (REPO / path).read_text()
    for word in words:
        assert word not in text, (path, word)


def test_find_nvcc_raises_when_absent(monkeypatch):
    from deepfbsdejsolvers_torch.ops import _build

    if Path("/usr/local/cuda/bin/nvcc").is_file():
        pytest.skip("this machine has /usr/local/cuda/bin/nvcc")
    monkeypatch.setattr(shutil, "which", lambda name: None)
    monkeypatch.delenv("CUDA_HOME", raising=False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


def test_chip_smoke_fails_without_a_card_or_the_package(tmp_path):
    r = _run([str(REPO / "chip_smoke.py")], REPO)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = _run(["chip_smoke.py"], tmp_path)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
