"""No module of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the program: each import's top-level name
(the part before the first dot) compared whole."""

import ast

import pytest

from benchmark import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "deepfbsdejsolvers_tpu"}
FILES = sorted(p for p in harness.HERE.rglob("*.py")
               if "_cache" not in p.parts)


def top_level_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: str(p.relative_to(harness.HERE)))
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize(
    "path", [p for p in FILES if "tests" not in p.parts],
    ids=lambda p: str(p.relative_to(harness.HERE)))
def test_runs_neither_bench_nor_chip_smoke(path):
    assert not top_level_imports(path) & {"bench", "chip_smoke"}


@pytest.mark.parametrize(
    "path", sorted((harness.HERE / "reference").glob("*.py")),
    ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    allowed = {"__future__", "contextlib", "math", "typing", "numpy",
               "scipy", "torch", "benchmark"}
    assert top_level_imports(path) <= allowed
    text = path.read_text()
    assert "import benchmark." not in text or all(
        line.split()[1].startswith("benchmark.reference")
        for line in text.splitlines() if line.startswith("from benchmark"))


def test_the_name_check_is_whole():
    # the port's name begins with the JAX package's: a prefix match would
    # refuse it
    assert "deepfbsdejsolvers_torch".split(".")[0] not in FORBIDDEN


def test_configs_name_the_port_only():
    for path in (harness.HERE / "configs").glob("*.json"):
        text = path.read_text()
        assert "deepfbsdejsolvers_tpu" not in text and "jax" not in text
