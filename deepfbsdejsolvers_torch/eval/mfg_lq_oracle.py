"""Exact initial values for the linear-quadratic corner of the MFG model.

With the jump-window terms off (``f0 = f1 = 0``) the Pontryagin controls
lose their R-gated terms and become affine in (hQ, Q, hY, Y), the driver
f(U) = C·U and terminal g(X) = h1 + h2·X are affine, and the jumps decouple
(dN enters the controls only through the R gate, whose coefficient is then
0).  The coupled FBSDE is linear and the time-0 state deterministic, so
Y0_hat / Y0 equal the mean solution of a deterministic two-point boundary
value problem:

  forward   E[hS_{i+1}] = E[hS_i] + dt·E[α̂_i]
  backward  E[hY_i]     = E[hY_{i+1}] + C·dt·E[hS_i]
  terminal  E[hY_N]     = h1 + h2·E[hS_N]

with E[α̂_i] = −(p0 + m·E[hQ_i] + E[hY_i])/k_hat affine (k_hat = A +
(1 − π)·ce·p1 + K, m = π·p1 + (1 − π)·ce·p1 + K), and the same structure
for the full pair (S, Y) with A + K in place of k_hat and the known E[α̂]
in the price term.  E[hQ_i] (= E[Q_i]) follows the discrete Euler OU mean
recursion of ``SmartGridMFGModel.step_consumption``, not the model's
continuous-time ``mean_hq_table`` (which enters only the f1-gated terms,
zero here).

The affine TPBVP is solved exactly (to float64 rounding) by the backward
decoupling E[hY_i] = p_i + q_i·E[hS_i]:

  D   = 1 + q_{i+1}·dt/k_hat
  q_i = (q_{i+1} + C·dt)/D
  p_i = (p_{i+1} − q_{i+1}·dt·(p0 + m·mq_i)/k_hat)/D

with (p_N, q_N) = (h1, h2) and Y0_hat = p_0 + q_0·S0; D is implicit because
the solvers' controls use the pre-update hY_i.  Numpy float64 on the host,
O(N).  At the comparison profile the value is Y0 = −48.320138.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from deepfbsdejsolvers_torch.models.mfg_smart_grid import SmartGridMFGModel


@dataclasses.dataclass(frozen=True)
class LQOracle:
    """Exact mean solution of the f0=f1=0 (linear-quadratic) MFG system."""

    y0_hat: float          # E[hY_0] — the hat BSDE initial value
    y0: float              # E[Y_0]  — the full BSDE initial value
    mean_hy: np.ndarray    # (N+1,) E[hY_i]
    mean_y: np.ndarray     # (N+1,) E[Y_i]
    mean_hs: np.ndarray    # (N+1,) E[hS_i]
    mean_s: np.ndarray     # (N+1,) E[S_i]
    mean_hq: np.ndarray    # (N+1,) E[hQ_i] = E[Q_i] (discrete Euler OU mean)


def _check_lq(model: SmartGridMFGModel) -> None:
    if model.f0 != 0.0 or model.f1 != 0.0:
        raise ValueError(
            "the LQ oracle is exact only with the jump-window terms off "
            f"(f0 = f1 = 0); got f0={model.f0}, f1={model.f1}. Build the "
            "model with make_mfg_default(f0=0.0, f1=0.0).")


def _euler_mean_hq(model: SmartGridMFGModel) -> np.ndarray:
    """Discrete Euler OU mean matching SmartGridMFGModel.step:
    m_{i+1} = m_i + coeff_ou*(q_aver[i+1] - m_i)*dt, m_0 = q_aver[0]."""
    q = np.asarray(model.q_aver, np.float64)
    n, dt, c = model.N, model.dt, model.coeff_ou
    m = np.empty(n + 1)
    m[0] = q[0]
    for i in range(n):
        m[i + 1] = m[i] + c * (q[i + 1] - m[i]) * dt
    return m


def _solve_affine_tpbvp(n: int, dt: float, c_driver: float, k_div: float,
                        e_i: np.ndarray, h1: float, h2: float,
                        x0: float):
    """Solve the scalar affine TPBVP

      X_{i+1} = X_i - dt*(e_i + Y_i)/k_div
      Y_i     = Y_{i+1} + c_driver*dt*X_i,   Y_N = h1 + h2*X_N

    exactly via the backward decoupling Y_i = p_i + q_i*X_i.  Returns
    (X trajectory, Y trajectory), each (n+1,)."""
    p = np.empty(n + 1)
    q = np.empty(n + 1)
    p[n], q[n] = h1, h2
    for i in range(n - 1, -1, -1):
        d = 1.0 + q[i + 1] * dt / k_div
        q[i] = (q[i + 1] + c_driver * dt) / d
        p[i] = (p[i + 1] - q[i + 1] * dt * e_i[i] / k_div) / d
    x = np.empty(n + 1)
    y = np.empty(n + 1)
    x[0] = x0
    y[0] = p[0] + q[0] * x0
    for i in range(n):
        x[i + 1] = x[i] - dt * (e_i[i] + y[i]) / k_div
        y[i + 1] = p[i + 1] + q[i + 1] * x[i + 1]
    return x, y


def solve_lq(model: SmartGridMFGModel) -> LQOracle:
    """Exact Y0_hat / Y0 (plus mean trajectories) for an f0=f1=0 model.

    Matches the discretization of ``MFGSolver`` rollouts term by term
    (``solvers/mfg.py`` ``_pair_global``; MFGSolvers.py:24-47): controls
    and the driver use the pre-step state; hY consumes the pre-update hY.
    """
    _check_lq(model)
    n, dt = model.N, model.dt
    ce = model.coeff_equi
    pi, p0, p1 = model.pi, model.p0, model.p1
    A, K, C = model.A, model.K, model.C
    mq = _euler_mean_hq(model)

    # --- hat system: k_hat = A + (1-pi)*ce*p1 + K (calpha_hat with the
    # f1-gate coefficient zero), price slope m on hQ.
    k_hat = A + (1.0 - pi) * ce * p1 + K
    m = pi * p1 + (1.0 - pi) * ce * p1 + K
    e_hat = p0 + m * mq[:n]
    hs, hy = _solve_affine_tpbvp(n, dt, C, k_hat, e_hat, model.h1, model.h2,
                                 model.S0)

    # --- full system: E[alpha_hat_i] from the solved hat pair feeds the
    # dynamic-price term of calpha (MFGModel.py:87-89, f-terms zero);
    # E[Q_i] = E[hQ_i] (same Euler mean recursion, zero-mean noise).
    a_hat = -(p0 + m * mq[:n] + hy[:n]) / k_hat
    e_full = (K * mq[:n] + p0 + pi * p1 * mq[:n]
              + (1.0 - pi) * ce * p1 * (mq[:n] + a_hat))
    s, y = _solve_affine_tpbvp(n, dt, C, A + K, e_full, model.h1, model.h2,
                               model.S0)

    return LQOracle(y0_hat=float(hy[0]), y0=float(y[0]), mean_hy=hy,
                    mean_y=y, mean_hs=hs, mean_s=s, mean_hq=mq)
