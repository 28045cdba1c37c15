"""The port's MFG solver against the JAX package's at fixed params and
noise: each scheme's pair loss (hat, full) within 1e-5 relative and the
gradient of their sum, every parameter as one global norm, within 3e-5.

The model is the N = 12 truncation of the 1-day model (tests/test_mfg.py),
batch 256, hidden (8, 8) and once the default widths.  The noise is JAX's
``_prenoise`` draw, handed to the port as tensors: with the icdf sampler
the (u, z) the counts are drawn from; with the exact sampler the counts
themselves, rebuilt on the JAX side as its loss draws them,
``sample_dN(keys[i], state_i)`` on the keys ``_prenoise`` splits, along a
rollout under zero controls, which leaves hQ, and so every λ·dt, as the
loss has it.  Each test first holds the port's counts (from its exogenous
pass) to JAX's.  The JAX side runs at full f32 matmul precision; its scan
is flat (``scan_chunk=0``)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepfbsdejsolvers_torch.models.mfg_smart_grid import (
    make_mfg_default as torch_mfg)
from deepfbsdejsolvers_torch.nets.mlp import param_leaves
from deepfbsdejsolvers_torch.ops import rollout as R
from deepfbsdejsolvers_torch.ops import sweep as S
from deepfbsdejsolvers_torch.solvers.mfg import MFG_SCHEMES
from deepfbsdejsolvers_torch.solvers.mfg import MFGSolver as TorchMFG
from deepfbsdejsolvers_torch.utils.convert import params_to_jax
from deepfbsdejsolvers_tpu.models.mfg_smart_grid import (
    make_mfg_default as jax_mfg)
from deepfbsdejsolvers_tpu.solvers.mfg import MFGSolver as JaxMFG
from test_torch_mfg_model import tiny
from test_torch_pricing import port_params, rel_norm

BATCH = 256
SMALL = dict(hidden_hat=(8, 8), hidden=(8, 8))


def make_pair(scheme, sampler="icdf", model_kw=None, **kw):
    """(JAX solver, port solver on the CPU, JAX params)."""
    model_kw = model_kw or {}
    jm = dataclasses.replace(tiny(jax_mfg, **model_kw), jump_sampler=sampler)
    tm = dataclasses.replace(tiny(torch_mfg, **model_kw),
                             jump_sampler=sampler)
    js = JaxMFG(jm, scheme, **kw)
    ts = TorchMFG(tm, scheme, device="cpu", **kw)
    return js, ts, js.init_params(jax.random.key(3))


def jax_counts(js, key, batch, noise):
    """The counts JAX's loss draws on ``key``: its state's hQ ignores the
    controls, so a zero-control rollout meets every λ·dt of the loss."""
    model = js.model
    dw0, dw, jn = noise
    state = model.init_state(batch)
    zero = jnp.zeros((batch,), jnp.float32)
    dns = []
    for i in range(model.N):
        if model.jump_sampler == "icdf":
            dn, _ = model.sample_dN_from(jn[0][i], jn[1][i], state)
        else:
            dn, _ = model.sample_dN(jn[i], state)
        dns.append(dn)
        state = model.step(state, dw0[i], dw[i], dn, zero, zero)
    return np.asarray(jnp.stack(dns))


def jax_noise(js, key, batch):
    """(port noise as tensors, JAX's counts): icdf (dW0, dW, (u, z)),
    exact (dW0, dW, dN)."""
    noise = js._prenoise(key, batch)
    dn = jax_counts(js, key, batch, noise)
    t = [torch.tensor(np.asarray(a)) for a in noise[:2]]
    if js.model.jump_sampler == "icdf":
        jn = tuple(torch.tensor(np.asarray(a)) for a in noise[2])
    else:
        jn = torch.tensor(dn)
    return (t[0], t[1], jn), dn


def assert_pair_matches(js, ts, jparams, batch=BATCH, key=11):
    key = jax.random.key(key)
    with jax.default_matmul_precision("highest"):
        pair_j = jax.jit(js.build_pair_loss(batch))(jparams, key)
        grads_j = jax.jit(jax.grad(
            lambda p, k: sum(js.build_pair_loss(batch)(p, k))))(jparams, key)
    noise, dn_j = jax_noise(js, key, batch)
    np.testing.assert_array_equal(ts.exogenous(noise).dn.numpy(), dn_j)
    p = port_params(jparams)
    lh, lf = ts.build_pair_loss_from_noise(batch)(p, noise)
    grads = torch.autograd.grad(lh + lf, param_leaves(p))
    assert float(lh.detach()) == pytest.approx(float(pair_j[0]), rel=1e-5)
    assert float(lf.detach()) == pytest.approx(float(pair_j[1]), rel=1e-5)
    rel = rel_norm([g.numpy() for g in grads],
                   [np.asarray(g) for g in jax.tree_util.tree_leaves(
                       grads_j)])
    assert rel < 3e-5, rel
    for name in ("hat", "full"):
        assert sum(float(g.abs().sum()) for g, t in zip(grads, param_leaves(p))
                   if any(t is u for u in param_leaves(p[name]))) > 0, name


@pytest.mark.parametrize("scheme", MFG_SCHEMES)
def test_icdf_pair_loss_matches_jax(scheme):
    js, ts, jparams = make_pair(scheme, **SMALL)
    assert_pair_matches(js, ts, jparams)


@pytest.mark.parametrize("scheme", MFG_SCHEMES)
def test_exact_pair_loss_matches_jax(scheme):
    js, ts, jparams = make_pair(scheme, sampler="exact", **SMALL)
    assert_pair_matches(js, ts, jparams)


@pytest.mark.parametrize("scheme", ["global", "sumlocal"])
def test_default_widths_and_mfc_internalization_match_jax(scheme):
    """hidden (20, 20) / (22, 22), the aggregate-MFC price (coeff_equi 2)
    at π = 0.5, without remat."""
    js, ts, jparams = make_pair(scheme, model_kw=dict(coeff_equi=2.0,
                                                      pi=0.5), remat=False)
    assert_pair_matches(js, ts, jparams, key=12)


def test_hat_loss_is_independent_of_the_full_net():
    """couplage OFF is well posed: ∂(hat loss)/∂(full params) = 0."""
    for scheme in ("global", "sumlocal"):
        _, ts, jparams = make_pair(scheme, **SMALL)
        p = port_params(jparams)
        loss_hat, _ = ts.build_pair_loss(64)(p, torch.Generator()
                                             .manual_seed(0))
        g = torch.autograd.grad(loss_hat, param_leaves(p),
                                allow_unused=True)
        by_net = {name: sum(float(x.abs().sum()) for x, t in
                            zip(g, param_leaves(p)) if x is not None and any(
                                t is u for u in param_leaves(p[name])))
                  for name in ("hat", "full")}
        assert by_net["full"] == 0.0 and by_net["hat"] > 0.0, by_net


def test_net_wiring_and_params_round_trip():
    for scheme in MFG_SCHEMES:
        js, ts, jparams = make_pair(scheme)
        want = {k: (s.n_in, s.hidden, s.n_out, s.with_y0)
                for k, s in js.net_specs().items()}
        got = {k: (s.n_in, s.hidden, s.n_out, s.with_y0)
               for k, s in ts.net_specs().items()}
        assert got == want, scheme
        assert ts.head_dims() == js.head_dims()
        back = params_to_jax(port_params(jparams))
        assert sorted(back) == ["full", "hat"]
        for a, b in zip(jax.tree_util.tree_leaves(back),
                        jax.tree_util.tree_leaves(jparams)):
            np.testing.assert_array_equal(a, np.asarray(b))
        shapes = [tuple(t.shape) for t in param_leaves(
            ts.init_params(torch.Generator().manual_seed(0)))]
        assert shapes == [tuple(np.shape(x)) for x in
                          jax.tree_util.tree_leaves(jparams)]


def test_refusals():
    m = tiny(torch_mfg)
    for kw in (dict(fuse_heads=True), dict(compute_dtype="bfloat16")):
        TorchMFG(m, "global", device="cpu", **kw)
    with pytest.raises(ValueError, match="compute_dtype"):
        TorchMFG(m, "global", device="cpu", compute_dtype="float16")
    with pytest.raises(ValueError, match="scheme"):
        TorchMFG(m, "multistep1", device="cpu")
    ts = TorchMFG(m, "global", device="cpu", scan_chunk=4, **SMALL)
    with pytest.raises(ValueError, match="couplage"):
        ts.train(0, 8, 8, 1, 1, 1e-3, verbose=False, couplage="on")
    with pytest.raises(ValueError, match="no trainable y0"):
        TorchMFG(m, "sumlocal", device="cpu").warm_start_y0(
            {}, torch.Generator())
    gen = torch.Generator().manual_seed(0)
    noise = ts._prenoise(gen, 16)
    with pytest.raises(ValueError, match="noise must be"):
        ts.build_pair_loss_from_noise(8)(ts.init_params(gen), noise)


def test_train_on_a_mesh_of_one():
    """``train(mesh=...)`` on a world of one rank (gloo, in this process):
    the global batch is the rank's, and training moves both read-outs."""
    from deepfbsdejsolvers_torch.parallel.data_parallel import optional_mesh

    ts = TorchMFG(tiny(torch_mfg), "global", device="cpu", **SMALL)
    with optional_mesh(True, "cpu") as mesh:
        res = ts.train(0, 8, 8, 2, 2, 1e-2, verbose=False, mesh=mesh)
    y0s = [res.y0_hat_history, res.y0_history]
    assert np.all(np.isfinite(y0s)) and np.all(np.isfinite(res.loss_history))
    assert all(h[0] != h[1] for h in y0s)


def test_cpu_training_launches_no_kernel_and_needs_no_card():
    """The MFG paths launch none of B1–B4; without a card the default
    device raises instead of falling back to the CPU."""
    counters = (R.b1_forward, R.b2_backward, S.b3_forward, S.b4_backward)
    before = [f.launches for f in counters]
    _, ts, jparams = make_pair("multistep", **SMALL)
    p = port_params(jparams)
    lh, lf = ts.build_pair_loss(32)(p, torch.Generator().manual_seed(1))
    (lh + lf).backward()
    assert [f.launches for f in counters] == before
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            TorchMFG(tiny(torch_mfg), "global").init_params(
                torch.Generator().manual_seed(0))
