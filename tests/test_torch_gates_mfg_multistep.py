"""One row of the port's gate runner trained on the CPU at the smoke budget of
tests/test_torch_gates.py: the MFG linear-quadratic corner of the
comparison model, multistep (heads Z0, Γ, Z), 120 steps
at batch 128, against the exact oracle."""

import pytest

from test_torch_gates import check_gate, one_thread  # noqa: F401

pytestmark = pytest.mark.gates

GATES = ["mfg_lq_multistep"]


@pytest.mark.parametrize("name", GATES)
def test_gate_config_trains(name):
    check_gate(name)
