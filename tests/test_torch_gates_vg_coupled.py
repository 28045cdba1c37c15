"""One row of the port's gate runner trained on the CPU at the smoke budget of
tests/test_torch_gates.py: the coupled Variance-Gamma global scheme at
N = 240, hidden (64, 64), on the hoisted piecewise tables."""

import pytest

from test_torch_gates import check_gate, one_thread  # noqa: F401

pytestmark = pytest.mark.gates

GATES = ["vg_coupled_direct"]


@pytest.mark.parametrize("name", GATES)
def test_gate_config_trains(name):
    check_gate(name)
