"""The fused rollout operator: its CPU path is the plain loop, its
preconditions are enforced before anything touches CUDA, and the semantic
Merton-form probe rejects dynamics the kernels do not implement."""

import dataclasses

import pytest
import torch

from deepfbsdejsolvers_torch.models.merton import make_merton_default
from deepfbsdejsolvers_torch.nets.mlp import param_leaves
from deepfbsdejsolvers_torch.ops import rollout as R
from deepfbsdejsolvers_torch.ops.compensator import CompensatorSpec
from deepfbsdejsolvers_torch.solvers.pricing import PricingSolver
from deepfbsdejsolvers_torch.solvers.train import make_generator

CHEB64 = CompensatorSpec(x_interp="chebyshev", n_cheb=64)
HOIST = dict(compensator=CHEB64, hoist=True, hoist_interp="piecewise")


def _model(n=3):
    return dataclasses.replace(make_merton_default(
        jump_sampler="icdf", price_mode="chebyshev"), N=n)


def _inputs(hidden=8, batch=300):
    model = _model()
    solver = PricingSolver(model, "global", hidden=(hidden, hidden),
                           fused_rollout=True, device="cpu", **HOIST)
    params = solver.init_params(make_generator("cpu", 1, 0))
    for t in param_leaves(params):
        t.requires_grad_(True)
    dw, j = solver._prenoise(make_generator("cpu", 1, 1), batch)
    tables = solver._hoist_tables(params, (dw, j))
    return model, params, tables, dw, j


def test_cpu_path_is_rollout_plain():
    model, params, tables, dw, j = _inputs()
    op = R.FusedRolloutOp(model, 8)
    x1, y1 = op(params["gam"], params["uz"]["y0"], tables, dw, j)
    x2, y2 = R.rollout_plain(model, params["gam"], params["uz"]["y0"],
                             tables, dw, j)
    assert torch.equal(x1, x2) and torch.equal(y1, y2)
    g1 = torch.autograd.grad(torch.mean(y1 * x1), param_leaves(params),
                             retain_graph=True)
    g2 = torch.autograd.grad(torch.mean(y2 * x2), param_leaves(params))
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))
    assert R.b1_forward.launches == 0 and R.b2_backward.launches == 0


def test_form_probe_accepts_merton_rejects_nonaffine_increments():
    base = make_merton_default()

    class CrossTerm:
        def __getattr__(self, name):
            return getattr(base, name)

        def uncoupled_log_increments(self, dw, j):
            return base.uncoupled_log_increments(dw, j) + 0.05 * dw * j

    class QuadraticDW:
        def __getattr__(self, name):
            return getattr(base, name)

        def uncoupled_log_increments(self, dw, j):
            return base.uncoupled_log_increments(dw, j) + 0.05 * dw * dw

    r, a_lin, sigma, drift, x0 = R.merton_form_constants(base)
    assert (r, a_lin, sigma, x0) == (0.1, pytest.approx(0.1), 0.3, 1.0)
    assert drift == pytest.approx(float(base.uncoupled_log_increments(
        torch.zeros(()), torch.zeros(()))))
    assert R.merton_form_constants(CrossTerm()) is None
    assert R.merton_form_constants(QuadraticDW()) is None
    with pytest.raises(ValueError, match="Merton-form"):
        R.FusedRolloutOp(CrossTerm(), 8)


@pytest.mark.parametrize("kw,match", [
    (dict(hidden=(8, 16)), "two equal layers"),
    (dict(hidden=(129, 129)), "two equal layers"),
    (dict(hidden=(8, 8), hoist_interp="clenshaw"), "piecewise"),
    (dict(hidden=(8, 8), pw_degree=5), "pw_degree"),
    (dict(hidden=(8, 8), activation="relu"), "activation"),
])
def test_fused_preconditions_raise_before_touching_cuda(kw, match):
    """An unmet precondition raises ValueError at construction on
    device="cuda", before any allocation: on a machine without a card the
    first CUDA allocation would raise something else."""
    args = dict(HOIST, **kw)
    with pytest.raises(ValueError, match=match):
        PricingSolver(_model(), "global", fused_rollout=True, device="cuda",
                      **args)
    assert PricingSolver(_model(), "global", device="cpu",
                         **args).fused_unmet()


def test_operator_rejects_unbuilt_widths_and_degrees():
    for h in (0, 129):
        with pytest.raises(ValueError, match="hidden widths"):
            R.FusedRolloutOp(_model(), h)
    with pytest.raises(ValueError, match="degree"):
        R.FusedRolloutOp(_model(), 8, degree=5)


def test_kernel_wrappers_refuse_cpu_tensors_without_building():
    """The wrappers validate before they build or launch anything."""
    model, params, tables, dw, j = _inputs()
    op = R.FusedRolloutOp(model, 8)
    w = tuple(t.detach() for t in (*params["gam"]["W"], *params["gam"]["b"]))
    weights = (w[0], w[3], w[1], w[4], w[2])
    tabs = {k: v.detach() for k, v in tables.items()}
    with pytest.raises(ValueError, match="CUDA tensors"):
        R.b1_forward(op.spec, weights, params["uz"]["y0"].detach(), tabs, dw,
                     j, save=True)
    with pytest.raises(ValueError, match="CUDA tensors"):
        R.b2_backward(op.spec, weights, tabs, dw, j, dw, dw, dw[0], dw[0])
    assert R.b1_forward.launches == 0 and R.b2_backward.launches == 0


def test_cuda_request_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    with pytest.raises((AssertionError, RuntimeError)):
        PricingSolver(_model(), "global", hidden=(8, 8), fused_rollout=True,
                      **HOIST)


@pytest.mark.parametrize("kw", [
    dict(hoist_z=False),
    dict(compute_dtype="bfloat16"),
    dict(adjoint=True, hoist_z=False),
    dict(hoist_gamma=True),
])
def test_unported_configurations_raise(kw):
    """Each configuration builds on the CPU; what the fused kernels do not
    take raises ValueError under ``fused_rollout=True``, and an unmet
    precondition of the hand-written adjoint raises on the card, where the
    CPU warns and falls back to autograd."""
    args = dict(HOIST, hidden=(8, 8), **kw)
    if kw.get("adjoint"):
        with pytest.warns(UserWarning, match="falling back"):
            PricingSolver(_model(), "global", device="cpu", **args)
        with pytest.raises(ValueError, match="adjoint=True precondition"):
            PricingSolver(_model(), "global", device="cuda", **args)
        return
    PricingSolver(_model(), "global", device="cpu", **args)
    with pytest.raises(ValueError, match="fused_rollout=True precondition"):
        PricingSolver(_model(), "global", device="cpu", fused_rollout=True,
                      **args)


def test_hoist_with_comp_axis_raises():
    """The hoisted tables sweep every node at once: compensator sharding
    is for the un-hoisted sweep, as in the JAX package."""
    with pytest.raises(ValueError, match="hoist=True is incompatible"):
        PricingSolver(_model(), "global", hidden=(8, 8), device="cpu",
                      comp_axis="comp", comp_shards=2, **HOIST)


def test_b2_blocks_are_capped_independently_of_the_batch():
    """One block per 128-path tile, at most 528 (four on each of the
    H100's 132 SMs): every block walks at least one tile, as the kernel
    requires, and past the cap the blocks walk more tiles instead."""
    assert [R.b2_blocks(b) for b in (
        1, 128, 129, 1000, 2**16, 528 * 128, 528 * 128 + 1, 2**17,
        2**19)] == [1, 1, 2, 8, 512, 528, 528, 528, 528]


@pytest.mark.parametrize("n", [50, 1600])
@pytest.mark.parametrize("batch", [1, 37, 2**14 + 37, 2**17, 2**19])
def test_b2_partials_stay_within_their_bound(n, batch):
    """B2's partial buffer holds at most 528 × (H² + 6H + 1 + N·3·P·D)
    floats at any batch: at N = 1600 and 2^19 paths 650 MB, where one
    partial per tile would take 5.0 GB."""
    h, p = 21, 8
    blocks, per_block = R.b2_partial_shape(n, batch, h, p)
    assert per_block == h * h + 6 * h + 1 + n * 3 * p * R.KERNEL_COEFFS
    assert 1 <= blocks <= -(-batch // 128)
    assert blocks * per_block <= 528 * (h * h + 6 * h + 1 + n * 3 * p * 8)


_ROW_FITS = (2**31 - 1 - (21 * 21 + 6 * 21 + 1)) // (3 * 8 * 8)


@pytest.mark.parametrize("n,batch,fits", [
    (1, 2**31 - 128, True), (1, 2**31 - 127, False),
    (50, (2**31 - 1) // 50, True), (50, (2**31 - 1) // 50 + 1, False),
    (_ROW_FITS, 1, True), (_ROW_FITS + 1, 1, False)])
def test_sizes_past_the_kernels_32_bit_indices_raise(n, batch, fits):
    """The path-steps N·B, the paths up to the end of their last 128-wide
    tile and B2's partial rows of H² + 6H + 1 + N·3·P·D floats are indexed
    in 32-bit ints, so sizes past them raise before anything builds or
    launches."""
    from deepfbsdejsolvers_torch.ops import _build

    if fits:
        R._check_sizes(n, batch, 21, 8)
    else:
        with pytest.raises(ValueError, match="32-bit"):
            R._check_sizes(n, batch, 21, 8)
    assert "rollout_fwd" not in _build._LOADED
    assert "rollout_bwd" not in _build._LOADED
