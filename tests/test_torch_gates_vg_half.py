"""One row of the port's gate runner trained on the CPU at the smoke budget of
tests/test_torch_gates.py: the Variance-Gamma global scheme at half the
coupling (aLin = 0.05), the Chebyshev compensator, warm Y0."""

import pytest

from test_torch_gates import check_gate, one_thread  # noqa: F401

pytestmark = pytest.mark.gates

GATES = ["vg_half_coupling"]


@pytest.mark.parametrize("name", GATES)
def test_gate_config_trains(name):
    check_gate(name)
