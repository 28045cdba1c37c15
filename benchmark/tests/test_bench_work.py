"""The frozen work counts against ``chip_smoke.py``'s ``work()``, less the
forward B2 and B4 recompute, at B = 2^17; the cells' compensator node
counts, which the sweep rooflines and ``step_mfu`` read."""

import importlib.util

import pytest

from benchmark import harness, work

B, N, P = 2 ** 17, 50, 8


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_for_counts", harness.ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("h", [8, 21])
def test_rollout_counts(smoke, h):
    assert work.rollout_fwd(N, B, h, P) == smoke.work("B1", N, B, h, P)
    flops, nbytes = smoke.work("B2", N, B, h, P)
    # B2 recomputes the head's layers (2H² + 12H) and three table values
    recompute = N * B * (2 * h * h + 12 * h + 3 * 24)
    assert work.rollout_bwd(N, B, h, P) == (flops - recompute, nbytes)


@pytest.mark.parametrize("h,m", [(8, 49), (21, 49), (21, 96), (21, 5000)])
def test_sweep_counts(smoke, h, m):
    assert work.sweep_fwd(m, B, h) == smoke.work("B3", m, B, h, P)
    flops, nbytes = smoke.work("B4", m, B, h, P)
    # B4 recomputes the hidden layers, 2H² + 5H a path-node
    assert work.sweep_bwd(m, B, h) == (flops - m * B * (2 * h * h + 5 * h),
                                       nbytes)


def test_peaks_match(smoke):
    assert work.PEAK_FP32_FLOPS == smoke.PEAK_FP32_FLOPS
    assert work.PEAK_BYTES == smoke.PEAK_BYTES


def test_bounds_are_operation_bound_at_the_cells():
    for count in (work.rollout_fwd(N, 2 ** 19, 21, P),
                  work.rollout_bwd(N, 2 ** 19, 21, P),
                  work.sweep_fwd(96, 2 ** 19, 21),
                  work.sweep_bwd(49, 2 ** 19, 21)):
        flops, nbytes = count
        assert work.bound_s(flops, nbytes) == flops / work.PEAK_FP32_FLOPS


def test_network_flops():
    h = (21, 21)
    assert work.mlp_forward_flops(3, h, 1) == 2 * 21 * 21 + 12 * 21 + 1
    assert work.mlp_forward_flops(2, h, 1) == 2 * 21 * 21 + 10 * 21 + 1
    wl, cfg = harness.load_cell("merton.parity")
    f3, f2 = work.mlp_forward_flops(3, h, 1), work.mlp_forward_flops(2, h, 1)
    assert work.step_network_flops(wl, cfg, B, 49) == B * N * (50 * f3 + f2)
    wl, cfg = harness.load_cell("vg.parity")
    assert work.step_network_flops(wl, cfg, B, 96) == B * 30 * 97 * f3
    wl, cfg = harness.load_cell("merton.fused_speed")
    assert work.step_network_flops(wl, cfg, B, 49) == (
        B * N * f3 + N * 64 * (49 * f3 + f2))


@pytest.mark.parametrize("cell,nodes", [
    ("merton.fused_speed", 49), ("merton.parity", 49), ("vg.parity", 96),
    ("merton.parity_mc", 5000)])
def test_node_count(cell, nodes):
    assert harness.node_count(*harness.load_cell(cell)) == nodes


def test_network_flops_at_a_monte_carlo_compensator():
    wl, cfg = harness.load_cell("merton.parity_mc")
    f3 = work.mlp_forward_flops(3, (21, 21), 1)
    f2 = work.mlp_forward_flops(2, (21, 21), 1)
    m = harness.node_count(wl, cfg)
    assert work.step_network_flops(wl, cfg, 2 ** 16, m) == (
        2 ** 16 * N * (5001 * f3 + f2))
    # B3's and B4's bounds at M = 5000 and the cell's batch: operation-bound
    for count in (work.sweep_fwd(m, 2 ** 16, 21),
                  work.sweep_bwd(m, 2 ** 16, 21)):
        assert work.bound_s(*count) == count[0] / work.PEAK_FP32_FLOPS
