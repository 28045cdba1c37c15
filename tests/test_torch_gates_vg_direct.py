"""One row of the port's gate runner trained on the CPU at the smoke budget of
tests/test_torch_gates.py: the Variance-Gamma parity configuration (exact
gamma jumps, the per-path FFT price, the direct 40-node sweep), global
scheme."""

import pytest

from test_torch_gates import check_gate, one_thread  # noqa: F401

pytestmark = pytest.mark.gates

GATES = ["vg_direct"]


@pytest.mark.parametrize("name", GATES)
def test_gate_config_trains(name):
    check_gate(name)
