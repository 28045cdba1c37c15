"""The sweep kernels' wide widths: ``sweep_impl="pallas"`` takes two equal
tanh layers of any width up to 128, as the JAX package's Pallas sweep does.
The port's parity-path loss with ``sweep_impl="pallas"`` (on the CPU the
plain version of the rank-1 sweep the wide kernels compute on the card)
equals JAX's with its Pallas sweep in interpret mode, as on any machine
without a TPU, at hidden 20, 64, 100 and 128: loss rel 1e-5, gradients of
every parameter as one global norm rel 3e-5.  The Merton model is cut to
N = 3 steps at B = 64 paths (interpret mode is slow); the noise is JAX's,
handed to the port as tensors.  Also: the width checks of the two kernel
pairs, the wide kernels' tiling and scratch bounds, and the wrappers'
refusals before anything builds."""

import dataclasses
import types

import jax
import numpy as np
import pytest
import torch

from deepfbsdejsolvers_torch.models.merton import (
    make_merton_default as torch_merton)
from deepfbsdejsolvers_torch.models.variance_gamma import (
    make_vg_default as torch_vg)
from deepfbsdejsolvers_torch.nets.mlp import param_leaves
from deepfbsdejsolvers_torch.ops import _build
from deepfbsdejsolvers_torch.ops import sweep as S
from deepfbsdejsolvers_torch.ops.compensator import (
    CompensatorSpec as TorchComp)
from deepfbsdejsolvers_torch.solvers.pricing import PricingSolver as TorchPS
from deepfbsdejsolvers_tpu.models.merton import (
    make_merton_default as jax_merton)
from deepfbsdejsolvers_tpu.solvers.pricing import PricingSolver as JaxPS
from test_torch_parity import jax_noise
from test_torch_pricing import port_params, rel_norm

N, BATCH = 3, 64


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("hidden", [20, 64, 100, 128])
def test_wide_pallas_loss_and_grads_match_jax(hidden):
    jm = dataclasses.replace(jax_merton(), N=N)
    tm = dataclasses.replace(torch_merton(), N=N)
    kw = dict(hidden=(hidden, hidden), sweep_impl="pallas")
    js = JaxPS(jm, "global", **kw)
    ts = TorchPS(tm, "global", device="cpu", **kw)
    assert ts.sweep_unmet() == [] and js._pallas_ok(
        js.init_params(jax.random.key(0)))
    jparams = js.init_params(jax.random.key(3))
    key = jax.random.key(11)
    with jax.default_matmul_precision("highest"):
        lj, gj = jax.jit(jax.value_and_grad(js.build_loss(BATCH)))(jparams,
                                                                   key)
    p = port_params(jparams)
    lt = ts.build_loss_from_noise(BATCH)(p, jax_noise(js, key, BATCH))
    gt = torch.autograd.grad(lt, param_leaves(p))
    assert float(lt.detach()) == pytest.approx(float(lj), rel=1e-5)
    rel = rel_norm([g.numpy() for g in gt],
                   [np.asarray(g) for g in jax.tree_util.tree_leaves(gj)])
    assert rel < 3e-5, rel


@pytest.mark.parametrize("kw,match", [
    (dict(hidden=(129, 129)), "1..128"),
    (dict(hidden=(64, 32)), "two equal layers"),
    (dict(hidden=(64, 64, 64)), "two equal layers"),
    (dict(hidden=(64, 64), activation="relu"), "activation"),
])
def test_sweep_unmet_refuses_what_the_kernels_do_not_take(kw, match):
    """sweep_unmet names the reason, and sweep_impl="pallas" raises with it
    at construction on the card's device, before any allocation."""
    model = dataclasses.replace(torch_merton(), N=3)
    reasons = TorchPS(model, "global", device="cpu", **kw).sweep_unmet()
    assert any(match in r for r in reasons), reasons
    with pytest.raises(ValueError, match=match):
        TorchPS(model, "global", sweep_impl="pallas", device="cuda", **kw)


@pytest.mark.parametrize("h", [1, 8, 20, 21, 33, 64, 100, 128])
def test_sweep_takes_every_width_up_to_128(h):
    """Both regimes' one-output heads at any width 1..128, and the fused
    rollout's head too."""
    for model, scheme in ((torch_merton(), "global"),
                          (torch_merton(), "sumlocal2"),
                          (torch_vg(), "multistep1")):
        s = TorchPS(dataclasses.replace(model, N=3), scheme,
                    hidden=(h, h), device="cpu")
        assert s.sweep_unmet() == []
    fused = TorchPS(dataclasses.replace(torch_merton(price_mode="chebyshev"),
                                        N=3), "global",
                    hidden=(h, h), device="cpu", hoist=True,
                    hoist_interp="piecewise",
                    compensator=TorchComp(x_interp="chebyshev"))
    assert fused.fused_unmet() == []


def test_fused_unmet_still_refuses_64():
    """The fused rollout takes every width up to 128 since the wide B1/B2
    (tests/test_torch_rollout_wide.py); past it, it still refuses."""
    with pytest.raises(ValueError, match=r"two equal layers of a width in "
                                         r"1\.\.128"):
        TorchPS(dataclasses.replace(torch_merton(price_mode="chebyshev"),
                                    N=3), "global",
                hidden=(129, 129), device="cuda", hoist=True,
                hoist_interp="piecewise", fused_rollout=True,
                compensator=TorchComp(x_interp="chebyshev"))


@pytest.mark.parametrize("h,hp,tile", [(1, 32, 128), (20, 32, 128),
                                       (32, 32, 128), (33, 64, 128),
                                       (64, 64, 128), (65, 128, 128),
                                       (100, 128, 128), (128, 128, 128)])
def test_width_classes_and_tiles(h, hp, tile):
    """The width class HP each H pads to, and the paths per block: eight
    warps of one 16-path tensor-core tile each at every class
    (csrc/sweep_wide.cuh ``Mma``)."""
    assert S.wide_class(h) == hp
    assert S.b4_wide_tile() == tile


@pytest.mark.parametrize("h", [0, 129])
def test_widths_outside_1_to_128_are_refused(h):
    with pytest.raises(ValueError, match="1..128"):
        S.wide_class(h)


@pytest.mark.parametrize("h,batch", [(20, 1), (20, 2**17), (64, 2**20),
                                     (128, 37), (128, 2**17 + 37)])
def test_wide_b4_blocks_stay_within_their_bound(h, batch):
    """Every block walks at least one tile, at most 264 blocks whatever the
    batch, so the partial buffer stays within 264 × (H² + H + 3·M·H)
    floats."""
    blocks = S.b4_wide_blocks(batch, h)
    assert 1 <= blocks <= min(-(-batch // S.b4_wide_tile()), 264)
    # the buffer the wide B4 is given is sized by these blocks
    assert S.b4_partial_shape(batch, 49, h) == (
        blocks, h * h + h + 3 * 49 * h)


def test_kernels_dispatch_by_width():
    """The specialised pair at 8 and 21, the wide pair elsewhere."""
    assert S.sweep_kernels(8) == (S.b3_forward, S.b4_backward)
    assert S.sweep_kernels(21) == (S.b3_forward, S.b4_backward)
    for h in (1, 20, 64, 128):
        assert S.sweep_kernels(h) == (S.b3_wide_forward,
                                      S.b4_wide_backward)


@pytest.mark.parametrize("h", [8, 21])
def test_wide_wrappers_refuse_the_specialised_widths(h):
    """8 and 21 have their specialised pair: the wide pair refuses them
    before building, so each width has one build and one partial size.
    Stand-ins with a CUDA device get the wrappers past the device check on
    a machine without a card."""
    def on_card(*shape):
        return types.SimpleNamespace(device=torch.device("cuda"),
                                     ndim=len(shape), shape=shape)

    x, a = on_card(16), on_card(5, h)
    for call in (lambda: S.b3_wide_forward(x, a, a, a, a, a),
                 lambda: S.b4_wide_backward(x, a, a, a, a, a, x)):
        with pytest.raises(ValueError, match="specialised sweep kernels"):
            call()
    assert "sweep_wide_fwd" not in _build._LOADED
    assert "sweep_wide_bwd" not in _build._LOADED


def test_wide_wrappers_refuse_cpu_tensors_before_building():
    h, m, batch = 64, 5, 16
    x = torch.ones(batch)
    a = c = v = torch.ones(m, h)
    args = (x, a, c, torch.ones(h, h), torch.ones(h), v)
    with pytest.raises(ValueError, match="CUDA tensors"):
        S.b3_wide_forward(*args)
    with pytest.raises(ValueError, match="CUDA tensors"):
        S.b4_wide_backward(*args, torch.ones(batch))
    assert "sweep_wide_fwd" not in _build._LOADED
    assert "sweep_wide_bwd" not in _build._LOADED
    before = (S.b3_wide_forward.launches, S.b4_wide_backward.launches)
    # on CPU tensors the sweep is the plain version
    out = S.fused_sweep(*args)
    assert torch.equal(out, S.sweep_plain(*args))
    assert (S.b3_wide_forward.launches,
            S.b4_wide_backward.launches) == before
