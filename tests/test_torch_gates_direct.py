"""One row of the port's gate runner trained on the CPU at the smoke budget
of tests/test_torch_gates.py: the reference-faithful multistep1 with the
direct 49-node sweep (150 steps, see test_torch_gates.py)."""

import pytest

from test_torch_gates import check_gate, one_thread  # noqa: F401

pytestmark = pytest.mark.gates

GATES = ["merton_direct"]


@pytest.mark.parametrize("name", GATES)
def test_gate_config_trains(name):
    check_gate(name)
