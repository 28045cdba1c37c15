"""The port's MFG evaluators against the JAX package's, on JAX's noise:
the Picard warm start of the global scheme's two scalars, the expected
costs of ``simulate_global_err``, the mean/std paths of ``follow_s``
(population std), the frozen-noise pre-draw, its replay
(``simulate_all_processes``), the players' objective and the Price of
Anarchy, each within 1e-5 relative; and the linear-quadratic oracle, numpy
float64 on both sides, within 1e-12 relative at the comparison and the
1-day profiles.  The solver tests' N = 12 model, hidden (8, 8)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepfbsdejsolvers_torch.eval.mfg_lq_oracle import solve_lq
from deepfbsdejsolvers_torch.eval.mfg_solutions import (
    FrozenNoise, MFGFixedTrajectoryEvaluator, draw_frozen_noise,
    frozen_counts, price_of_anarchy)
from deepfbsdejsolvers_torch.models.mfg_smart_grid import (
    make_mfg_default as torch_mfg)
from deepfbsdejsolvers_torch.solvers.mfg import MFGSolver as TorchMFG
from deepfbsdejsolvers_tpu.eval import mfg_solutions as jsol
from deepfbsdejsolvers_tpu.eval.mfg_lq_oracle import solve_lq as jax_solve_lq
from deepfbsdejsolvers_tpu.models.mfg_smart_grid import (
    make_mfg_default as jax_mfg)
from test_torch_mfg_losses import SMALL, jax_noise, make_pair
from test_torch_pricing import port_params

BATCH = 512


@pytest.mark.parametrize("sampler", ["icdf", "exact"])
def test_warm_start_matches_jax(sampler):
    """The fictitious-play Picard read-outs after 1, 3 and 24 iterates."""
    js, ts, jparams = make_pair("global", sampler=sampler, **SMALL)
    key = jax.random.key(21)
    noise, _ = jax_noise(js, key, BATCH)
    p = port_params(jparams)
    for n_picard in (1, 3, 24):
        with jax.default_matmul_precision("highest"):
            want = js.warm_start_y0(jparams, key, batch=BATCH,
                                    n_picard=n_picard)
        got = ts.warm_start_y0_from_noise(p, noise, n_picard)
        for side in ("hat", "full"):
            assert float(got[side]["y0"]) == pytest.approx(
                float(want[side]["y0"]), rel=1e-5), (n_picard, side)
            assert got[side]["W"] is p[side]["W"]


@pytest.mark.parametrize("scheme", ["global", "sumlocal", "multistep_reg"])
def test_simulate_global_err_and_follow_s_match_jax(scheme):
    js, ts, jparams = make_pair(scheme, **SMALL)
    key = jax.random.key(22)
    noise, _ = jax_noise(js, key, BATCH)
    p = port_params(jparams)
    with jax.default_matmul_precision("highest"):
        want = js.simulate_global_err(jparams, key, BATCH)
        want_s = js.follow_s(jparams, key, BATCH)
    got = ts.simulate_global_err_from_noise(p, noise)
    for a, b in zip(got, want):
        assert float(a) == pytest.approx(float(b), rel=1e-5)
    got_s = ts.follow_s_from_noise(p, noise)
    for a, b in zip(got_s, want_s):
        assert a.shape == (ts.model.N + 1,)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5 * float(np.abs(b).max()))
    # the std paths are the population std (no n − 1)
    hs = next(s for i, s, *_ in ts.policy_states(p, ts.exogenous(noise))
              if i == ts.model.N)
    assert float(got_s[1][-1]) == pytest.approx(
        float(np.std(hs.detach().numpy())), rel=1e-5)


def _jax_frozen(jm, key, n_sim):
    """JAX's pre-draw, and the per-column (u, z) its icdf sampler drew."""
    dw0, dws, dn = jsol.draw_frozen_noise(jm, key, n_sim)
    keys = jax.random.split(jax.random.split(key, 3)[2], jm.N + 1)
    u, z = [], []
    for k in keys:
        ku, kz = jax.random.split(k)
        u.append(jax.random.uniform(ku, (n_sim,), jnp.float32))
        z.append(jax.random.normal(kz, (n_sim,), jnp.float32))
    return dw0, dws, dn, (np.stack(u), np.stack(z))


@pytest.mark.parametrize("scheme", ["global", "sumlocal"])
def test_frozen_replay_objective_and_poa_match_jax(scheme):
    js, ts, jparams = make_pair(scheme, **SMALL)
    js2 = dataclasses.replace(js, model=dataclasses.replace(
        js.model, coeff_equi=2.0))
    ts2 = dataclasses.replace(ts, model=dataclasses.replace(
        ts.model, coeff_equi=2.0))
    n_sim = 64
    dw0, dws, dn, (u, z) = _jax_frozen(js.model, jax.random.key(5), n_sim)
    t = lambda a: torch.tensor(np.asarray(a))
    dn_t = frozen_counts(ts.model, t(dw0), (t(u), t(z)))
    np.testing.assert_array_equal(dn_t.numpy(), np.asarray(dn))
    p = port_params(jparams)
    jn = jsol.FrozenNoise(dW0=dw0, dW=dws[0], dN=dn)
    tn = FrozenNoise(dW0=t(dw0), dW=t(dws[0]), dN=dn_t)
    with jax.default_matmul_precision("highest"):
        jev = jsol.MFGFixedTrajectoryEvaluator(js, jparams, jn)
        want = jev.simulate_all_processes(n_sim)
        want_poa = jsol.price_of_anarchy(
            jev, jsol.MFGFixedTrajectoryEvaluator(js2, jparams, jn), n_sim)
    tev = MFGFixedTrajectoryEvaluator(ts, p, tn)
    got = tev.simulate_all_processes(n_sim)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        v = np.asarray(v)
        assert isinstance(got[k], np.ndarray) and got[k].shape == v.shape, k
        np.testing.assert_allclose(got[k], v, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(v).max()) + 1e-30,
                                   err_msg=k)
    got_poa = price_of_anarchy(tev, MFGFixedTrajectoryEvaluator(ts2, p, tn),
                               n_sim)
    for k, v in want_poa.items():
        assert got_poa[k] == pytest.approx(v, rel=1e-5), k
    # a policy against itself: exactly 1
    assert price_of_anarchy(tev, MFGFixedTrajectoryEvaluator(ts, p, tn),
                            n_sim)["poa"] == 1.0
    with pytest.raises(ValueError, match="exceeds"):
        tev.simulate_all_processes(n_sim + 1)


def test_frozen_noise_draw_is_shared_and_deterministic():
    m = dataclasses.replace(torch_mfg(nb_days=1), jump_sampler="icdf")
    a = draw_frozen_noise(m, torch.Generator().manual_seed(3), 32)
    b = draw_frozen_noise(m, torch.Generator().manual_seed(3), 32)
    for x, y in zip((a[0], *a[1], a[2]), (b[0], *b[1], b[2])):
        assert torch.equal(x, y) and x.shape == (32, m.N + 1)
    assert not torch.equal(a[1][0], a[1][1])
    exact = draw_frozen_noise(torch_mfg(nb_days=1),
                              torch.Generator().manual_seed(3), 32)[2]
    assert torch.all(exact >= 0) and torch.equal(exact, exact.round())


@pytest.mark.parametrize("nb_days", [2, 1])
def test_lq_oracle_equals_jax(nb_days):
    mine = solve_lq(torch_mfg(nb_days=nb_days, f0=0.0, f1=0.0))
    theirs = jax_solve_lq(jax_mfg(nb_days=nb_days, f0=0.0, f1=0.0))
    for name in ("y0_hat", "y0", "mean_hy", "mean_y", "mean_hs", "mean_s",
                 "mean_hq"):
        np.testing.assert_allclose(getattr(mine, name), getattr(theirs, name),
                                   rtol=1e-12, atol=0.0, err_msg=name)
    if nb_days == 2:
        assert mine.y0_hat == pytest.approx(-48.320138, abs=1e-6)
    assert abs(mine.y0 - mine.y0_hat) < 1e-10 * abs(mine.y0_hat)
    with pytest.raises(ValueError, match="f0 = f1 = 0"):
        solve_lq(torch_mfg(nb_days=nb_days))


def test_zero_noise_rollout_matches_the_oracle():
    """With zero noise every recursion is affine: the model's own step fed
    the oracle's mean Y tables reproduces its mean hS/S paths."""
    model = torch_mfg(f0=0.0, f1=0.0)
    oracle = solve_lq(model)
    state = model.init_state(1, "cpu")
    zero = torch.zeros(1)
    hs, s = [0.0], [0.0]
    for i in range(model.N):
        state = model.step(state, zero, zero, zero,
                           torch.tensor([oracle.mean_hy[i]], dtype=torch.float32),
                           torch.tensor([oracle.mean_y[i]], dtype=torch.float32))
        hs.append(float(state.hS[0]))
        s.append(float(state.S[0]))
    np.testing.assert_allclose(hs, oracle.mean_hs, atol=2e-4)
    np.testing.assert_allclose(s, oracle.mean_s, atol=2e-4)
    assert abs(float(state.hQ[0]) - oracle.mean_hq[-1]) < 1e-5


def test_picard_warm_start_agrees_with_the_oracle():
    """The Monte-Carlo Picard estimate lands within 2e-2 of the exact LQ
    value at the comparison profile (batch 8192, 24 iterates)."""
    model = dataclasses.replace(torch_mfg(f0=0.0, f1=0.0),
                                jump_sampler="icdf")
    oracle = solve_lq(model)
    ts = TorchMFG(model, "global", device="cpu")
    params = ts.init_params(torch.Generator().manual_seed(0))
    warm = ts.warm_start_y0(params, torch.Generator().manual_seed(7),
                            batch=8192)
    for side, want in (("hat", oracle.y0_hat), ("full", oracle.y0)):
        assert abs(float(warm[side]["y0"]) - want) / abs(want) < 2e-2, side
