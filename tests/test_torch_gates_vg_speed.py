"""One row of the port's gate runner trained on the CPU at the smoke budget of
tests/test_torch_gates.py: the Variance-Gamma speed configuration (hoisted
piecewise tables, icdf jumps, the collocated FFT price), global scheme."""

import pytest

from test_torch_gates import check_gate, one_thread  # noqa: F401

pytestmark = pytest.mark.gates

GATES = ["vg_speed"]


@pytest.mark.parametrize("name", GATES)
def test_gate_config_trains(name):
    check_gate(name)
