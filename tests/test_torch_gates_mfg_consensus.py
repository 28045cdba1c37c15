"""One row of the port's gate runner trained on the CPU at the smoke budget of
tests/test_torch_gates.py: the MFG consensus of the warm-started global
scheme and sumlocal on the default comparison model, 60 steps each at batch
128, their expected costs on one shared draw of 1024 paths."""

import pytest

from test_torch_gates import check_gate, one_thread  # noqa: F401

pytestmark = pytest.mark.gates

GATES = ["mfg_consensus"]


@pytest.mark.parametrize("name", GATES)
def test_gate_config_trains(name):
    check_gate(name)
