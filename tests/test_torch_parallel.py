"""Data parallelism of the port on a world of four gloo ranks on the CPU,
held against the JAX package's ``make_dp_loss`` on a 4-device virtual mesh
and against serial evaluations, as tests/test_parallel.py holds the JAX
package.  One spawn of four ranks (``parallel_checks`` in
tests/torch_parallel_ranks.py, which imports no JAX) serves every test
that needs ranks; each test reads its part of the ranks' results.

Against JAX: each rank is fed JAX's shard noise ``_prenoise(fold_in(key,
i), batch)`` through ``build_loss_from_noise`` with the JAX params
converted; the mesh loss within 1e-5 and the gradients within 3e-5 as one
global norm, relative (tests/test_torch_parity.py's tolerances), in the
un-hoisted Merton global configuration, the hoisted piecewise speed
configuration and the VG speed configuration.  Against serial (the
hoisted speed configuration also through the hand-written adjoint, whose
gradients the mesh all-reduces after its backward, as JAX's
test_adjoint_under_shard_map composes its VJP with the mesh) (each
tolerance no looser than tests/test_parallel.py's): the mesh loss equals
the mean of the per-shard losses within 1e-6; the gradients within 2e-5
relative and 1e-7 absolute (1e-6 for the collocated configurations,
which the JAX package holds to finite gradients only); the compensator
sharded over (data 2, comp 2) equals the unsharded run within 1e-6
relative for the loss and, for the gradients, 2e-5 as one global norm and
1e-4 / 2e-6 leaf by leaf (the JAX package's 5e-4 / 5e-6); a fit under the mesh equals the serial fit of the mesh
mean under SGD within 2e-5 / 1e-7 for the params and 1e-5 / 1e-7 for the
losses, and leaves bit-identical params on every rank."""

import jax
import numpy as np
import pytest
import torch

import torch_parallel_ranks as tr
from deepfbsdejsolvers_torch.ops.compensator import (
    CompensatorSpec as TorchComp)
from deepfbsdejsolvers_torch.parallel.data_parallel import (
    Mesh, per_shard_batch)
from deepfbsdejsolvers_torch.parallel.launch import run_ranks
from deepfbsdejsolvers_tpu.models.merton import (
    make_merton_default as jax_merton)
from deepfbsdejsolvers_tpu.models.variance_gamma import (
    make_vg_default as jax_vg)
from deepfbsdejsolvers_tpu.ops.compensator import CompensatorSpec as JaxComp
from deepfbsdejsolvers_tpu.parallel.data_parallel import (
    make_dp_loss, make_mesh)
from deepfbsdejsolvers_tpu.solvers.pricing import PricingSolver as JaxPS
from test_torch_pricing import rel_norm

JAX_CASES = ("merton_direct", "merton_hoisted", "vg_speed")
BATCH = 16
COMP_CASES = ("quad_xla", "quad_pallas", "mc_xla", "mc_pallas")


def jax_solver(name):
    _, _, _, comp, solver = tr.CONFIGS[name]
    model = tr.make_model(name, {"merton": jax_merton, "vg": jax_vg})
    return JaxPS(model, "global", hidden=tr.HIDDEN,
                 compensator=JaxComp(**comp), **solver)


@pytest.fixture(scope="module")
def jax_results():
    """Per configuration: JAX's params, mesh loss and gradients on four
    devices, and each shard's noise."""
    key = jax.random.key(11)
    mesh = make_mesh((4,), devices=jax.devices()[:4])
    out = {}
    for name in JAX_CASES:
        js = jax_solver(name)
        params = js.init_params(jax.random.key(3))
        with jax.default_matmul_precision("highest"):
            dp = make_dp_loss(js.build_loss(BATCH), mesh)
            loss, grads = jax.jit(jax.value_and_grad(dp))(params, key)
        noise = []
        for i in range(tr.WORLD):
            dw, j, _ = js._prenoise(jax.random.fold_in(key, i), BATCH)
            noise.append((np.asarray(dw), np.asarray(j)))
        out[name] = dict(
            params=jax.tree_util.tree_map(np.asarray, params), noise=noise,
            batch=BATCH, loss=float(loss),
            grads=[np.asarray(g) for g in jax.tree_util.tree_leaves(grads)])
    return out


@pytest.fixture(scope="module")
def ranks(jax_results):
    cases = {name: {k: r[k] for k in ("params", "noise", "batch")}
             for name, r in jax_results.items()}
    return run_ranks(tr.parallel_checks, tr.WORLD, cases, device="cpu",
                     timeout=600)


@pytest.mark.parametrize("name", JAX_CASES)
def test_mesh_loss_and_grads_equal_jax(ranks, jax_results, name):
    want = jax_results[name]
    for r in ranks:
        loss, grads = r[f"jax_{name}"]
        assert loss == pytest.approx(want["loss"], rel=1e-5)
        assert rel_norm(grads, want["grads"]) < 3e-5


@pytest.mark.parametrize("name", ["merton_direct", "merton_cheb",
                                  "merton_hoisted", "merton_adjoint"])
def test_mesh_loss_equals_serial_mean(ranks, name):
    """The mesh loss (``make_dp_loss``, and the update's) == the mean of
    the per-shard losses computed serially at the same generators; the
    hoisted tables come from each shard's own noise."""
    want = float(np.mean(ranks[0][name]["serial_losses"]))
    for r in ranks:
        assert abs(r[name]["mesh_loss"] - want) < 1e-6
        assert abs(r[name]["mesh"][0] - want) < 1e-6


@pytest.mark.parametrize("name,atol", [("merton_direct", 1e-7),
                                       ("merton_cheb", 1e-6),
                                       ("merton_hoisted", 1e-6),
                                       ("merton_adjoint", 1e-6)])
def test_mesh_grads_equal_serial_grads(ranks, name, atol):
    """One all-reduce of the per-rank gradients == the one-process
    gradient of the mesh-mean loss, the same on every rank: within 1e-6 as
    one global norm, and leaf by leaf 2e-5 relative and ``atol`` (the JAX
    package's 1e-7 on the direct configuration; it holds the collocated
    ones to finite gradients only)."""
    _, want = ranks[0][name]["serial"]
    for r in ranks:
        assert rel_norm(r[name]["mesh"][1], want) < 1e-6
        for a, b in zip(r[name]["mesh"][1], want):
            np.testing.assert_allclose(a, b, rtol=2e-5, atol=atol)
        for a, b in zip(r[name]["mesh"][1], ranks[0][name]["mesh"][1]):
            np.testing.assert_array_equal(a, b)


def test_update_and_epoch_move_the_params(ranks):
    for r in ranks:
        u = r["update"]
        assert np.isfinite(u["l1"]) and np.isfinite(u["l2"])
        assert 0 < u["moved1"] < u["moved2"]
    assert len({r["update"]["moved2"] for r in ranks}) == 1


@pytest.mark.parametrize("case", COMP_CASES)
def test_compensator_sharding_matches_unsharded(ranks, case):
    """(data 2, comp 2): each comp rank sweeps half the nodes (the 13-node
    quadrature padded to 14, or 4 of each step's 8 Monte-Carlo draws) and
    the partials sum (average) over comp; loss and gradients equal the
    same world's unsharded run at the same noise, on every rank."""
    for r in ranks:
        res = r[f"comp_{case}"]
        (la, ga), (lb, gb) = res["unsharded"], res["sharded"]
        assert lb == pytest.approx(la, rel=1e-6)
        assert rel_norm(gb, ga) < 2e-5
        for a, b in zip(gb, ga):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=2e-6)


def test_fit_equals_serial_fit_of_mesh_mean(ranks):
    want = ranks[0]["fit_serial"]
    for r in ranks:
        for a, b in zip(r["fit"]["params"], want["params"]):
            np.testing.assert_allclose(a, b, rtol=2e-5, atol=1e-7)
        np.testing.assert_allclose(r["fit"]["loss"], want["loss"],
                                   rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(r["fit"]["y0"], want["y0"], rtol=2e-5)


def test_params_bit_identical_across_ranks_after_fit(ranks):
    assert len({r["fit"]["digest"] for r in ranks}) == 1
    assert len({tuple(r["fit"]["loss"]) for r in ranks}) == 1


def test_hoist_with_comp_axis_raises():
    with pytest.raises(ValueError, match="hoist=True is incompatible"):
        tr.torch_solver("merton_hoisted", comp_axis="comp", comp_shards=2)


def test_comp_shards_must_divide_n_mc():
    with pytest.raises(ValueError, match="must divide n_mc"):
        tr.torch_solver("merton_direct", comp=dict(kind="mc", n_mc=9),
                        comp_axis="comp", comp_shards=2)


def test_sharded_loss_needs_a_mesh_with_its_axis():
    """The comp axis is bound when the loss is built, as the JAX package's
    ``shard_map`` binds it: no mesh, or one without that axis at that
    size, raises."""
    s = tr.torch_solver("merton_direct", comp_axis="comp", comp_shards=2)
    mesh = Mesh(("data",), (2,), 0, torch.device("cpu"), "gloo", {})
    for bad in (None, mesh):
        with pytest.raises(ValueError, match="needs a mesh"):
            s.build_loss(8, bad)


def test_quadrature_pads_to_a_multiple_of_the_shards():
    """13 nodes over 2 shards: one zero-weight node, so each shard sweeps
    7 and the weight mass is unchanged."""
    base = tr.torch_solver("merton_direct")
    s = tr.torch_solver("merton_direct", comp_axis="comp", comp_shards=2)
    assert base._quad[0].shape == (13,) and s._quad[0].shape == (14,)
    assert float(s._quad[1][-1]) == 0.0
    assert torch.equal(s._quad[1][:13], base._quad[1])
    assert s.compensator == TorchComp(**tr.QUAD13)


def test_per_shard_batch_rounds_up():
    mesh = Mesh(("data", "comp"), (3, 2), 0, torch.device("cpu"), "gloo",
                {})
    assert per_shard_batch(10, mesh) == 4
    assert per_shard_batch(12, mesh) == 4
    assert per_shard_batch(1, mesh) == 1
    assert per_shard_batch(10, mesh, "comp") == 5
    assert [mesh.coord("data"), mesh.coord("comp")] == [0, 0]
