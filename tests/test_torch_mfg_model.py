"""The port's smart-grid MFG model against the JAX package's: the host
tables and the icdf depth equal, the intensity, the controls, one step and
the net features within 1e-6 relative on the same state, and the hybrid
icdf Cox sampler count for count on the same (u, z), over 1,050,000 draws
spread across the profile's trough (λ·dt ≈ 0.4), its peak (≈ 28) and a +5σ
excursion (≈ 3.5e3, the CLT branch).

The two libraries' f32 ``exp`` differ in the last bit on some arguments, so
λ·dt and the CDF levels can differ by an ulp; a uniform (or, above the
switch, a CLT value) that falls inside that ulp counts one jump apart.  The
sampler test allows only such mismatches: each must sit within a few f32
ulps of the level (or half-integer) it straddles, and it prints their count
and largest margin."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepfbsdejsolvers_torch.models.mfg_smart_grid import (
    MFGState, SmartGridMFGModel, daily_profile,
    make_mfg_default as torch_mfg)
from deepfbsdejsolvers_tpu.models.mfg_smart_grid import (
    make_mfg_default as jax_mfg)

B = 512


def tiny(make, **kw):
    """The N = 12 truncation of the 1-day model (tests/test_mfg.py)."""
    m = make(nb_days=1, **kw)
    return dataclasses.replace(
        m, T=12.0 * m.dt, q_aver=np.asarray(m.q_aver, np.float64)[:13])


def random_state(n, rng, i=5):
    """A spread of states at step ``i`` (numpy float32 columns)."""
    cols = dict(hQ=rng.uniform(0.15, 0.8, n), Q=rng.uniform(0.0, 1.2, n),
                R=rng.uniform(0.0, 0.3, n), hS=rng.normal(0.0, 0.05, n),
                S=rng.normal(0.0, 0.1, n))
    return i, {k: v.astype(np.float32) for k, v in cols.items()}


def both_states(jm, i, cols):
    js = jm.init_state(len(cols["hQ"]))._replace(
        i=jnp.asarray(i, jnp.int32), **{k: jnp.asarray(v)
                                        for k, v in cols.items()})
    ts = MFGState(i=i, **{k: torch.tensor(v) for k, v in cols.items()})
    return js, ts


def close(t, j, rtol=1e-6):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=rtol,
                               atol=rtol * float(np.abs(np.asarray(j)).max()))


@pytest.mark.parametrize("kw", [{}, dict(nb_days=1), dict(f0=0.0, f1=0.0)])
def test_tables_and_icdf_depth_equal_jax(kw):
    jm, tm = jax_mfg(**kw), torch_mfg(**kw)
    assert (tm.N, tm.dt) == (jm.N, jm.dt)
    assert tm._icdf_k_eff == jm._icdf_k_eff >= 50
    np.testing.assert_array_equal(tm.mean_hq_table,
                                  np.asarray(jm.mean_hq_table))
    np.testing.assert_array_equal(tm.tables("cpu")["q_aver"].numpy(),
                                  np.asarray(jm._q_aver))
    assert len(daily_profile(2)) == 96 and torch_mfg().N == 95


def test_icdf_refusals_match_jax():
    for bad in (dict(icdf_switch=81.0), dict(icdf_tail_tol=1e-300)):
        with pytest.raises(ValueError):
            dataclasses.replace(jax_mfg(), **bad)
        with pytest.raises(ValueError):
            dataclasses.replace(torch_mfg(), **bad)
    with pytest.raises(ValueError, match="jump_sampler"):
        dataclasses.replace(torch_mfg(), jump_sampler="rbg")


@pytest.mark.parametrize("kw", [
    {}, dict(coeff_equi=2.0), dict(jump_model="constant", jump_factor=12.0),
    dict(nb_days=2, pi=0.5, f0=1.0)])
def test_model_functions_equal_jax(kw):
    jm, tm = jax_mfg(**kw), torch_mfg(**kw)
    rng = np.random.default_rng(0)
    i, cols = random_state(B, rng)
    js, ts = both_states(jm, i, cols)
    hy = rng.normal(-40.0, 8.0, B).astype(np.float32)
    y = rng.normal(-40.0, 8.0, B).astype(np.float32)
    dw0, dw = (rng.normal(0.0, 0.1, B).astype(np.float32) for _ in range(2))
    dn = rng.poisson(0.5, B).astype(np.float32)
    tt = [torch.tensor(a) for a in (hy, y, dw0, dw, dn)]
    close(tm.intensity(ts), jm.intensity(js))
    close(tm.calpha_hat(ts, tt[0]), jm.calpha_hat(js, hy))
    close(tm.calpha(ts, tt[0], tt[1]), jm.calpha(js, hy, y))
    tn, jn = tm.step(ts, tt[2], tt[3], tt[4], tt[0], tt[1]), jm.step(
        js, dw0, dw, dn, hy, y)
    assert tn.i == int(jn.i) == i + 1
    for name in ("hQ", "Q", "R", "hS", "S"):
        close(getattr(tn, name), getattr(jn, name))
    close(tm.projected_features(ts), jm.projected_features(js))
    close(tm.all_features(ts), jm.all_features(js))
    close(tm.f(tt[0]), jm.f(hy))
    close(tm.g(tt[0]), jm.g(hy))


def test_jump_resets_the_clock():
    m = torch_mfg(nb_days=1)
    state = m.init_state(4, "cpu")
    zeros = torch.zeros(4)
    new = m.step(state, zeros, zeros, torch.tensor([0.0, 1.0, 0.0, 2.0]),
                 zeros, zeros)
    np.testing.assert_allclose(new.R.numpy(), [0.24 + m.dt, m.dt,
                                               0.24 + m.dt, m.dt], rtol=1e-6)


def _margin_ulps(u, levels):
    """Distance of each u to its nearest level, in f32 ulps of the level."""
    gap = np.abs(u[:, None] - levels)
    k = np.argmin(gap, axis=1)
    near = levels[np.arange(len(u)), k]
    return gap[np.arange(len(u)), k] / np.spacing(np.abs(near).astype(
        np.float32)).astype(np.float64)


@pytest.mark.parametrize("center", [0.6, 0.74, 0.9])
def test_icdf_sampler_counts_equal_jax(center):
    """350,000 draws per intensity band (1,050,000 over the three)."""
    jm = dataclasses.replace(jax_mfg(nb_days=1), jump_sampler="icdf")
    tm = dataclasses.replace(torch_mfg(nb_days=1), jump_sampler="icdf")
    n = 350_000
    rng = np.random.default_rng(int(center * 100))
    hq = (center + rng.uniform(-0.01, 0.01, n)).astype(np.float32)
    u = rng.uniform(0.0, 1.0, n).astype(np.float32)
    z = rng.standard_normal(n).astype(np.float32)
    js = jm.init_state(n)._replace(hQ=jnp.asarray(hq))
    dn_j, lam_j = jm.sample_dN_from(jnp.asarray(u), jnp.asarray(z), js)
    ts = tm.init_state(n, "cpu")._replace(hQ=torch.tensor(hq))
    dn_t, lam_t = tm.sample_dN_from(torch.tensor(u), torch.tensor(z), ts)
    dn_j, lam_j = np.asarray(dn_j), np.asarray(lam_j)
    dn_t, lam_t = dn_t.numpy(), lam_t.numpy()
    np.testing.assert_allclose(lam_t, lam_j, rtol=1e-6)
    bad = np.flatnonzero(dn_t != dn_j)
    margin = 0.0
    if bad.size:
        lam = lam_t[bad].astype(np.float64)
        big = lam > tm.icdf_switch
        if (~big).any():
            # the f32 CDF levels of the recurrence at these rates
            lr = np.minimum(lam_t[bad][~big], np.float32(tm.icdf_switch))
            p = np.exp(-lr.astype(np.float32))
            levels, cdf = [p], p
            for k in range(1, tm._icdf_k_eff + 1):
                p = (p * lr / np.float32(k)).astype(np.float32)
                cdf = (cdf + p).astype(np.float32)
                levels.append(cdf)
            margin = max(margin, float(_margin_ulps(
                u[bad][~big].astype(np.float64),
                np.stack(levels, 1).astype(np.float64)).max()))
        if big.any():
            x = lam[big] + np.sqrt(lam[big]) * z[bad][big]
            half = np.floor(x) + 0.5
            margin = max(margin, float((np.abs(x - half)
                                        / np.spacing(np.float32(x))).max()))
    print(f"icdf band {center}: {bad.size} of {n} counts differ, largest "
          f"margin {margin:.2f} ulps")
    assert margin <= 8.0
    assert bad.size <= 1e-3 * n
    # the law: mean and variance of the counts at the band's central rate
    lam_dt = tm.intensity_of(torch.tensor(center)) * tm.dt
    dn_c = tm.sample_dn(torch.tensor(u), torch.tensor(z),
                        lam_dt.expand(n)).numpy()
    lam_dt = float(lam_dt)
    assert abs(float(dn_c.mean()) - lam_dt) < 4.5 * np.sqrt(lam_dt / n) + 1e-3
    assert abs(float(dn_c.var()) / lam_dt - 1.0) < 0.05


def test_exact_sampler_moments():
    """torch.poisson's counts on the model's rates (the exact law)."""
    m = torch_mfg(nb_days=1)
    n = 200_000
    gen = torch.Generator().manual_seed(5)
    for hq in (0.6, 0.74, 0.9):
        state = m.init_state(n, "cpu")._replace(hQ=torch.full((n,), hq))
        dn, lam_dt = m.sample_dN(gen, state)
        rate = float(lam_dt[0])
        assert abs(float(dn.mean()) - rate) < 4.5 * np.sqrt(rate / n) + 1e-3
        assert abs(float(dn.var()) / rate - 1.0) < 0.05


def test_model_is_a_frozen_dataclass_of_the_jax_fields():
    theirs = {f.name for f in dataclasses.fields(jax_mfg())}
    ours = {f.name for f in dataclasses.fields(SmartGridMFGModel)}
    assert ours == theirs
    m = tiny(torch_mfg)
    assert m.N == 12 and tiny(jax_mfg).N == 12
