"""The fused rollout's wide widths: ``fused_rollout=True`` takes two equal
tanh layers of any width up to 128, as the JAX package's Pallas rollout
does.  The port's fused-path loss (on the CPU the plain loop, the function
the wide kernels B1w/B2w compute on the card) equals JAX's
``PricingSolver(fused_rollout=True)``, whose Pallas kernels run in
interpret mode as on any machine without a TPU, at hidden 20, 64 and 128:
loss rel 1e-5, gradients of every parameter as one global norm rel 3e-5,
the tolerances of tests/test_pallas_rollout.py.  As there, the kernel tile
is pinned to 1024 and the batch is 1024; the Merton speed model is cut to
N = 3 steps; the noise is JAX's ``_prenoise``, handed to the port as
tensors, and the weights go through ``utils/convert.params_from_jax``.
Also: the width checks, the dispatch by width, the wide B2's bounded
partial buffer, and the wrappers' refusals before anything builds."""

import dataclasses
import types

import jax
import numpy as np
import pytest
import torch

from deepfbsdejsolvers_torch.models.merton import (
    make_merton_default as torch_merton)
from deepfbsdejsolvers_torch.nets.mlp import param_leaves
from deepfbsdejsolvers_torch.ops import _build
from deepfbsdejsolvers_torch.ops import rollout as R
from deepfbsdejsolvers_torch.ops.compensator import (
    CompensatorSpec as TorchComp)
from deepfbsdejsolvers_torch.solvers.pricing import PricingSolver as TorchPS
from deepfbsdejsolvers_torch.solvers.train import make_generator
from deepfbsdejsolvers_tpu.models.merton import (
    make_merton_default as jax_merton)
from deepfbsdejsolvers_tpu.ops.compensator import CompensatorSpec as JaxComp
from deepfbsdejsolvers_tpu.solvers.pricing import PricingSolver as JaxPS
from test_torch_pricing import jax_noise, port_params, rel_norm

N, BATCH = 3, 1024
HOIST = dict(hoist=True, hoist_interp="piecewise")
SPEED = dict(jump_sampler="icdf", price_mode="chebyshev")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def small_tile(monkeypatch):
    """The JAX kernels' tile at the test's batch (tests/test_pallas_rollout.py
    pins it the same way: interpret mode is much faster on small tiles)."""
    import deepfbsdejsolvers_tpu.ops.pallas_rollout as pr
    monkeypatch.setattr(pr, "TILE", 1024)


def _solver(h, device="cpu", fused=True):
    model = dataclasses.replace(torch_merton(**SPEED), N=N)
    return TorchPS(model, "global", hidden=(h, h), fused_rollout=fused,
                   compensator=TorchComp(x_interp="chebyshev", n_cheb=64),
                   device=device, **HOIST)


@pytest.mark.parametrize("hidden", [20, 64, 128])
def test_fused_loss_and_grads_match_jax_fused(hidden, small_tile):
    jm = dataclasses.replace(jax_merton(**SPEED), N=N)
    js = JaxPS(jm, "global", hidden=(hidden, hidden), fused_rollout=True,
               compensator=JaxComp(x_interp="chebyshev", n_cheb=64), **HOIST)
    assert js._fused_ok(BATCH)
    ts = _solver(hidden)
    assert ts.fused_unmet() == []
    jparams = js.init_params(jax.random.key(3))
    key = jax.random.key(11)
    with jax.default_matmul_precision("highest"):
        lj, gj = jax.jit(jax.value_and_grad(js.build_loss(BATCH)))(jparams,
                                                                   key)
    _, _, noise = jax_noise(js, key, BATCH)
    p = port_params(jparams)
    lt = ts.build_loss_from_noise(BATCH)(p, noise)
    gt = torch.autograd.grad(lt, param_leaves(p))
    assert float(lt.detach()) == pytest.approx(float(lj), rel=1e-5)
    rel = rel_norm([g.numpy() for g in gt],
                   [np.asarray(g) for g in jax.tree_util.tree_leaves(gj)])
    assert rel < 3e-5, rel


@pytest.mark.parametrize("h", [1, 20, 33, 64, 100, 128])
def test_fused_unmet_is_empty_up_to_128(h):
    assert _solver(h).fused_unmet() == []


def test_fused_rollout_refuses_129():
    """Past the widest head the kernels take, the solver raises at
    construction, before any allocation on the card."""
    assert any("1..128" in r for r in _solver(129, fused=False).fused_unmet())
    with pytest.raises(ValueError, match=r"two equal layers of a width in "
                                         r"1\.\.128"):
        _solver(129, device="cuda")


def _inputs(h, batch=300):
    solver = _solver(h)
    params = solver.init_params(make_generator("cpu", 1, 0))
    for t in param_leaves(params):
        t.requires_grad_(True)
    dw, j = solver._prenoise(make_generator("cpu", 1, 1), batch)
    tables = solver._hoist_tables(params, (dw, j))
    return solver.model, params, tables, dw, j


@pytest.mark.parametrize("h", [20, 64])
def test_cpu_path_is_rollout_plain(h):
    model, params, tables, dw, j = _inputs(h)
    op = R.FusedRolloutOp(model, h)
    before = (R.b1_wide_forward.launches, R.b2_wide_backward.launches)
    x1, y1 = op(params["gam"], params["uz"]["y0"], tables, dw, j)
    x2, y2 = R.rollout_plain(model, params["gam"], params["uz"]["y0"],
                             tables, dw, j)
    assert torch.equal(x1, x2) and torch.equal(y1, y2)
    g1 = torch.autograd.grad(torch.mean(y1 * x1), param_leaves(params),
                             retain_graph=True)
    g2 = torch.autograd.grad(torch.mean(y2 * x2), param_leaves(params))
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))
    assert (R.b1_wide_forward.launches,
            R.b2_wide_backward.launches) == before


@pytest.mark.parametrize("h", [0, 129])
def test_operator_refuses_widths_outside_1_to_128(h):
    with pytest.raises(ValueError, match="1..128"):
        R.FusedRolloutOp(dataclasses.replace(torch_merton(**SPEED), N=N), h)


def test_kernels_dispatch_by_width():
    """The specialised pair at 8 and 21, the wide pair elsewhere."""
    for h in (8, 21):
        assert R.rollout_kernels(h) == (R.b1_forward, R.b2_backward)
    for h in (1, 20, 22, 64, 100, 128):
        assert R.rollout_kernels(h) == (R.b1_wide_forward,
                                        R.b2_wide_backward)


def _detached(h):
    model, params, tables, dw, j = _inputs(h)
    op = R.FusedRolloutOp(model, h)
    w = params["gam"]
    weights = tuple(t.detach() for t in (w["W"][0], w["b"][0], w["W"][1],
                                         w["b"][1], w["W"][2]))
    tabs = {k: v.detach() for k, v in tables.items()}
    return op.spec, weights, params["uz"]["y0"].detach(), tabs, dw, j


def test_wide_wrappers_refuse_cpu_tensors_before_building():
    spec, weights, y0, tabs, dw, j = _detached(64)
    with pytest.raises(ValueError, match="CUDA tensors"):
        R.b1_wide_forward(spec, weights, y0, tabs, dw, j, save=True)
    with pytest.raises(ValueError, match="CUDA tensors"):
        R.b2_wide_backward(spec, weights, tabs, dw, j, dw, dw, dw[0], dw[0])
    assert "rollout_wide_fwd" not in _build._LOADED
    assert "rollout_wide_bwd" not in _build._LOADED
    assert R.b1_wide_forward.launches == R.b2_wide_backward.launches == 0


@pytest.mark.parametrize("h", [8, 21])
def test_wide_wrappers_refuse_the_specialised_widths(h):
    """8 and 21 have their specialised pair: the wide pair refuses them
    before building, so each width has one build and one partial size (and
    the specialised pair refuses the rest).  A stand-in with a CUDA device
    gets the wrappers past the device check on a machine without a card."""
    spec, weights, y0, tabs, dw, j = _detached(h)
    on_card = types.SimpleNamespace(device=torch.device("cuda"), ndim=2,
                                    shape=dw.shape)
    with pytest.raises(ValueError, match="specialised rollout kernels"):
        R.b1_wide_forward(spec, weights, y0, tabs, on_card, j, save=True)
    with pytest.raises(ValueError, match="specialised rollout kernels"):
        R.b2_wide_backward(spec, weights, tabs, on_card, j, dw, dw, dw[0],
                           dw[0])
    wide = dataclasses.replace(spec, hidden=20)
    with pytest.raises(ValueError, match="built for hidden widths"):
        R.b1_forward(wide, weights, y0, tabs, on_card, j, save=True)
    assert "rollout_wide_fwd" not in _build._LOADED
    assert "rollout_fwd" not in _build._LOADED


@pytest.mark.parametrize("h", [8, 21, 20, 64, 100, 128])
@pytest.mark.parametrize("batch", [1, 37, 2**14 + 37, 2**17 + 37, 2**20])
def test_b2_partials_stay_within_a_bound_of_the_batch(h, batch):
    """Every block walks at least one tile, and the partial buffer stays
    within a block count fixed by the width (528 specialised blocks of 128
    paths; wide ones of 128 paths, as many as an H100 holds at once: 264 at
    the classes 32 and 64, 132 at 128) times H² + 6H + 1 + N·3·P·D floats,
    whatever the batch."""
    n, p = 50, 8
    blocks, per_block = R.b2_partial_shape(n, batch, h, p)
    assert per_block == h * h + 6 * h + 1 + n * 3 * p * R.KERNEL_COEFFS
    tile = 128 if h in (8, 21) else R.wide_tile(h)
    cap = 528 if h in (8, 21) else (132 if h > 64 else 264)
    assert 1 <= blocks <= min(-(-batch // tile), cap)


@pytest.mark.parametrize("h,hp,cap", [(1, 32, 264), (20, 32, 264),
                                      (33, 64, 264), (64, 64, 264),
                                      (100, 128, 132), (128, 128, 132)])
def test_wide_classes_and_tiles(h, hp, cap):
    """The width class each H pads to, and the paths per block, eight warps
    of one m16 tile of 16 paths at every class (csrc/rollout_wide.cuh, as
    the wide sweep); the wide B2's blocks at batch 2^17, capped by those
    an H100 holds at once at the class."""
    assert R.wide_class(h) == hp and R.wide_tile(h) == 128
    assert R.b2_wide_blocks(2**17, h) == min(2**17 // 128, cap)


@pytest.mark.parametrize("h,batch,fits", [
    (20, 2**31 - 256, True), (20, 2**31 - 255, False),
    (128, 2**31 - 256, True), (128, 2**31 - 255, False)])
def test_wide_sizes_past_the_wide_b1_tile_raise(h, batch, fits):
    """The wide B1's blocks take up to 256 paths (at HP 32), and its path
    index is a 32-bit int up to the end of its last block, so a batch past
    2^31 − 256 raises at every wide width before anything builds."""
    if fits:
        R._check_sizes(1, batch, h, 8)
    else:
        with pytest.raises(ValueError, match="32-bit"):
            R._check_sizes(1, batch, h, 8)
    assert "rollout_wide_fwd" not in _build._LOADED


def test_wide_scalars_carry_r_dt():
    """The wide kernels take r·dt where the specialised ones take the growth
    1 + r·dt: rounded to f32 the growth is off by up to 6e-8 relative, the
    same way at every step and path."""
    spec = _detached(20)[0]
    r_dt = spec.r * spec.dt
    special = [v.value for v in spec.scalars()]
    wide = [v.value for v in spec.scalars(wide=True)]
    assert special[1] == pytest.approx(1.0 + r_dt, rel=1e-7)
    assert wide[1] == pytest.approx(r_dt, rel=1e-7)
    assert special[:1] + special[2:] == wide[:1] + wide[2:]
