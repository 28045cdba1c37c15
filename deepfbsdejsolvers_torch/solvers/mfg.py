"""MFG smart-grid solver suite: 5 schemes × couplage ON/OFF.

Two BSDEs are trained jointly on the coupled forward system:

* the projected one  dĥY = −f(ĥS) dt + ĥZ0 dW0 + ĥΓ (dN − λdt)   (hat net,
  inputs (t, hQ, hS, R));
* the full one       dY  = −f(S) dt + Z0 dW0 + Γ (dN − λdt) + Z dW  (full
  net, inputs (t, Q, S, hQ, hS, R)).

The Cox compensator λ·dt is analytic: no compensator sweep, so no CUDA
kernel serves these paths.  ``couplage="ON"`` trains both nets on the
summed loss in one optimizer; ``"OFF"`` trains the hat net first with the
full net frozen, then the full net with the hat net frozen (the hat loss
depends on the hat params only, since hS moves with α̂(hY) alone).

Schemes (head outputs):

  scheme         hat / full head outputs
  -------------  ------------------------------------------
  global         (ĥZ0, ĥΓ) + Y0_hat / (Z0, Γ, Z) + Y0
  multistep      (ĥY, ĥZ0, ĥΓ) / (Y, Z0, Γ, Z)
  sumlocal       (ĥY, ĥZ0, ĥΓ) / (Y, Z0, Γ, Z)
  sumlocal_reg   (ĥY) / (Y)
  multistep_reg  (ĥY) / (Y)

**The exogenous pass.**  hQ, Q and R never see a control: hQ and Q move
with the profile, dW0 and dW; R with the jump counts dN, which are drawn at
the intensity of hQ.  So λ·dt, dN, R, the gate R ≤ θ and every control term
that (hQ, Q, R) fix are functions of the noise alone, not of the params.
``exogenous`` computes them once, before the differentiable rollout: hQ, Q
and R step by step with the model's own formulas in the same order, the
sampler on the whole (N, B) λ·dt at once (the icdf recurrence, or one
``torch.poisson``).  The rollout then carries only hS, S, hY and Y through
autograd.  The numbers are those of drawing dN inside each step, not an
approximation; and one draw serves every Picard iterate of
``warm_start_y0``, as the JAX package's fixed per-step keys do.

With ``remat`` the differentiable rollout runs under
``torch.utils.checkpoint`` (``ops/scan.py`` ``chunked_scan``): a step at a
time, or with ``scan_chunk`` a chunk of steps at a time; the loss and the
gradients are the same bit for bit.  The exogenous tables stay outside it.
``fuse_heads`` evaluates both heads a step as one MLP of block-diagonal
weights, built once a loss call (where the depths and activations of the
two heads match; else the split heads); ``compute_dtype="bfloat16"`` runs
the heads' matmuls in bf16.  The reference's Y0 pairing defect (the hat net
read on the full state) stays fixed.  ``train(mesh=...)`` trains
data-parallel (``parallel/data_parallel.py``), each data rank on its share
of the batch.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from deepfbsdejsolvers_torch.models.mfg_smart_grid import (
    FullTerms, HatTerms, MFGState, SmartGridMFGModel)
from deepfbsdejsolvers_torch.nets.mlp import (
    MLPSpec, compute_dtype_of, get_activation, init_mlp, mlp_apply)
from deepfbsdejsolvers_torch.ops.numerics import use_full_f32
from deepfbsdejsolvers_torch.ops.scan import chunked_scan
from deepfbsdejsolvers_torch.parallel.data_parallel import (
    broadcast_params, per_shard_batch)
from deepfbsdejsolvers_torch.solvers.train import fit, make_generator

MFG_SCHEMES = ("global", "multistep", "sumlocal", "sumlocal_reg",
               "multistep_reg")


def _suffix_sum(x: torch.Tensor) -> torch.Tensor:
    """S_i = Σ_{j≥i} x_j along axis 0."""
    return torch.flip(torch.cumsum(torch.flip(x, (0,)), 0), (0,))


def _detached(tree):
    """The params tree with every tensor detached (a frozen net)."""
    if isinstance(tree, dict):
        return {k: _detached(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_detached(v) for v in tree]
    return tree.detach()


class Exogenous(NamedTuple):
    """What the noise alone fixes: rows 0…N of the states and control
    terms, rows 0…N−1 of the increments."""

    hq: torch.Tensor        # (N+1, B)
    q: torch.Tensor         # (N+1, B)
    r: torch.Tensor         # (N+1, B)
    lam: torch.Tensor       # (N+1, B) intensity λ
    dn: torch.Tensor        # (N, B) jump counts
    dpi: torch.Tensor       # (N, B) dN − λ·dt
    dw0: torch.Tensor       # (N, B)
    dw: torch.Tensor        # (N, B)
    ht: HatTerms            # each (N+1, B)
    ft: FullTerms           # each (N+1, B)
    target: torch.Tensor    # (N+1, 1) the α target per step


@dataclasses.dataclass(frozen=True)
class MFGSolver:
    """Builds losses over params = {"hat": ..., "full": ...}; parameters,
    noise and tables live on ``device`` ("cuda" unless asked otherwise)."""

    model: SmartGridMFGModel
    scheme: str
    hidden_hat: Tuple[int, ...] = (20, 20)
    hidden: Tuple[int, ...] = (22, 22)
    activation_hat: str = "tanh"
    activation: str = "tanh"
    remat: bool = True
    compute_dtype: Optional[str] = None
    scan_chunk: int = 0
    fuse_heads: bool = False
    device: str = "cuda"

    def __post_init__(self):
        if self.scheme not in MFG_SCHEMES:
            raise ValueError(f"scheme must be one of {MFG_SCHEMES}, got "
                             f"{self.scheme!r}")
        object.__setattr__(self, "_cdtype",
                           compute_dtype_of(self.compute_dtype))
        use_full_f32()
        object.__setattr__(self, "_act_hat",
                           get_activation(self.activation_hat))
        object.__setattr__(self, "_act", get_activation(self.activation))

    # ---------------------------------------------------------------- nets
    @property
    def with_heads(self) -> bool:
        """Whether the loss carries Z0, Γ (and Z): all but the regressions."""
        return self.scheme in ("global", "multistep", "sumlocal")

    def head_dims(self) -> Tuple[int, int]:
        if self.scheme == "global":
            return 2, 3
        if self.scheme in ("multistep", "sumlocal"):
            return 3, 4
        return 1, 1

    def net_specs(self) -> Dict[str, MLPSpec]:
        d_hat, d_full = self.head_dims()
        with_y0 = self.scheme == "global"
        return {
            "hat": MLPSpec(4, self.hidden_hat, d_hat, self.activation_hat,
                           with_y0=with_y0),
            "full": MLPSpec(6, self.hidden, d_full, self.activation,
                            with_y0=with_y0),
        }

    def init_params(self, generator: torch.Generator) -> Dict[str, dict]:
        """Glorot-normal heads drawn from a CPU ``generator``, hat then
        full, on ``self.device``."""
        specs = self.net_specs()
        return {name: init_mlp(generator, specs[name], self.device)
                for name in ("hat", "full")}

    def _hat(self, params, state: MFGState) -> torch.Tensor:
        return mlp_apply(params["hat"], self.model.projected_features(state),
                         self._act_hat, self._cdtype)

    def _full(self, params, state: MFGState) -> torch.Tensor:
        return mlp_apply(params["full"], self.model.all_features(state),
                         self._act, self._cdtype)

    def _can_fuse_heads(self) -> bool:
        """Whether ``fuse_heads`` applies: both heads of one depth and one
        activation."""
        return (self.fuse_heads and self.activation_hat == self.activation
                and len(self.hidden_hat) == len(self.hidden))

    def _fused_weights(self, params) -> dict:
        """Per layer block-diag(W_hat, W_full) and the two biases side by
        side: both heads as one MLP, its off-diagonal blocks zero."""
        ws, bs = [], []
        for wh, bh, wf, bf in zip(params["hat"]["W"], params["hat"]["b"],
                                  params["full"]["W"], params["full"]["b"]):
            ws.append(torch.block_diag(wh, wf))
            bs.append(torch.cat([bh, bf], -1))
        return {"W": ws, "b": bs}

    def _pair_heads(self, params):
        """``heads(state) -> (hat, full)`` for one loss call: the fused
        chain, its weights built here once, or the two heads apart."""
        if not self._can_fuse_heads():
            return lambda state: (self._hat(params, state),
                                  self._full(params, state))
        fused = self._fused_weights(params)
        d_hat = self.head_dims()[0]
        model = self.model

        def heads(state):
            cols = torch.cat([model.projected_features(state),
                              model.all_features(state)], -1)
            out = mlp_apply(fused, cols, self._act, self._cdtype)
            return out[..., :d_hat], out[..., d_hat:]

        return heads

    def _heads(self, pair, exo: Exogenous, i: int, hs, s):
        """(hat, full) outputs at step ``i`` of the rollout, by ``pair``
        (``_pair_heads``)."""
        return pair(MFGState(i, exo.hq[i], exo.q[i], exo.r[i], hs, s))

    def controls(self, exo: Exogenous, i: int, hy, y):
        """(α̂, α) at step ``i`` from the tabulated terms."""
        model = self.model
        ht = HatTerms(*(t[i] for t in exo.ht))
        ft = FullTerms(*(t[i] for t in exo.ft))
        a_hat = model.alpha_hat_from(ht, hy)
        return a_hat, model.alpha_from(ht, ft, exo.hq[i], exo.target[i],
                                       a_hat, y)

    def _bsde_step(self, pair, exo, i, hs, s, hy, y):
        """(hY, Y) at step i + 1 of the global scheme's BSDEs:
        Y − dt·f(S) + Z0·dW0 + Γ·(dN − λdt) [+ Z·dW], the heads at step i."""
        model, dt = self.model, self.model.dt
        h_out, f_out = self._heads(pair, exo, i, hs, s)
        dw0, dw, dpi = exo.dw0[i], exo.dw[i], exo.dpi[i]
        hy_next = (hy - dt * model.f(hs) + h_out[..., 0] * dw0
                   + h_out[..., 1] * dpi)
        y_next = (y - dt * model.f(s) + f_out[..., 0] * dw0
                  + f_out[..., 1] * dpi + f_out[..., 2] * dw)
        return hy_next, y_next

    def _advance(self, exo, i, hs, s, hy, y):
        """(hS, S) at step i + 1 under the controls of (hY, Y)."""
        a_hat, a = self.controls(exo, i, hy, y)
        dt = self.model.dt
        return hs + a_hat * dt, s + a * dt

    # ---------------------------------------------------------------- noise
    def _prenoise(self, generator: torch.Generator, batch: int):
        """(dW0, dW, None) for one rollout: dW0 and dW (N, B) drawn on
        ``generator``; ``exogenous`` then draws the counts on it (the icdf
        sampler's (u, z), or ``torch.poisson`` once the intensities are
        known)."""
        n, dev = self.model.N, generator.device
        sdt = math.sqrt(self.model.dt)
        dw0 = sdt * torch.randn((n, batch), generator=generator, device=dev)
        dw = sdt * torch.randn((n, batch), generator=generator, device=dev)
        return dw0, dw, None

    def _check_noise(self, noise, batch: int) -> None:
        want = (self.model.N, batch)
        dw0, dw, jn = noise
        parts = [dw0, dw] + (list(jn) if isinstance(jn, tuple) else [jn])
        shapes = [tuple(t.shape) for t in parts if t is not None]
        if any(shape != want for shape in shapes):
            raise ValueError(f"noise must be (dW0, dW, jn) of shape {want}, "
                             f"got {shapes}")

    def exogenous(self, noise, generator: Optional[torch.Generator] = None
                  ) -> Exogenous:
        """The states, counts and control terms the noise fixes (module
        docstring).  ``noise`` is (dW0, dW, jn), jn either the (N, B) jump
        counts themselves, or the icdf sampler's (u, z), or None: the
        counts are then drawn on ``generator``."""
        model, dt = self.model, self.model.dt
        dw0, dw, jn = noise
        n = dw0.shape[0]
        with torch.no_grad():
            st = model.init_state(dw0.shape[1], dw0.device)
            hq, q = [st.hQ], [st.Q]
            for i in range(n):
                h, c = model.step_consumption(i, hq[-1], q[-1], dw0[i], dw[i])
                hq.append(h)
                q.append(c)
            hq, q = torch.stack(hq), torch.stack(q)
            lam = model.intensity_of(hq)
            lam_dt = lam[:n] * dt
            dn = model.counts(lam_dt, jn, generator)
            r = [st.R]
            for i in range(n):
                r.append(model.step_clock(r[-1], dn[i]))
            r = torch.stack(r)
            tb = model.tables(hq.device)
            m, tg = tb["mean_hq"][:, None], tb["target"][:, None]
            return Exogenous(hq, q, r, lam, dn, dn - lam_dt, dw0, dw,
                             model.hat_terms(hq, r, m, tg),
                             model.full_terms(hq, q, m), tg)

    def _scan(self, body, carry):
        """``chunked_scan`` of ``body(carry, i)`` over the N steps: under
        ``remat`` checkpointed a step at a time, or ``scan_chunk`` steps at
        a time."""
        n = self.model.N
        return chunked_scan(body, carry, range(n), n, self.scan_chunk,
                            remat=self.remat)

    # ------------------------------------------------------------- rollouts
    def build_pair_loss_from_noise(self, batch: int) -> Callable:
        """``loss(params, noise) -> (loss_hat, loss_full)`` on given noise
        (``exogenous``'s forms), so that the same noise can drive this
        solver and another implementation."""
        pair = getattr(self, f"_pair_{self.scheme.split('_')[0]}")

        def loss(params, noise):
            self._check_noise(noise, batch)
            return pair(params, self.exogenous(noise))

        return loss

    def build_pair_loss(self, batch: int) -> Callable:
        """``loss(params, generator) -> (loss_hat, loss_full)``, the noise
        drawn on ``generator`` (on ``self.device``)."""
        pair = getattr(self, f"_pair_{self.scheme.split('_')[0]}")

        def loss(params, generator):
            noise = self._prenoise(generator, batch)
            return pair(params, self.exogenous(noise, generator))

        return loss

    def build_losses(self, batch: int) -> Dict[str, Callable]:
        """"hat", "full" and "coupled" (their sum) scalar losses."""
        pair = self.build_pair_loss(batch)

        def coupled(p, g):
            loss_hat, loss_full = pair(p, g)
            return loss_hat + loss_full

        return {"hat": lambda p, g: pair(p, g)[0],
                "full": lambda p, g: pair(p, g)[1], "coupled": coupled}

    def _pair_global(self, params, exo: Exogenous):
        """Y0 carried forward by the BSDE from the trainable scalars; the
        terminal loss E(Y_N − g(X_N))² of each side."""
        model = self.model
        b = exo.hq.shape[1]
        ones = torch.ones((b,), device=exo.hq.device)
        hy = params["hat"]["y0"] * ones
        y = params["full"]["y0"] * ones
        hs = s = torch.full((b,), model.S0, device=exo.hq.device)
        pair = self._pair_heads(params)

        def body(carry, i):
            hs, s, hy, y = carry
            hy_next, y_next = self._bsde_step(pair, exo, i, hs, s, hy, y)
            hs, s = self._advance(exo, i, hs, s, hy, y)
            return (hs, s, hy_next, y_next), None

        (hs, s, hy, y), _ = self._scan(body, (hs, s, hy, y))
        return (torch.mean(torch.square(hy - model.g(hs))),
                torch.mean(torch.square(y - model.g(s))))

    def _pair_multistep(self, params, exo: Exogenous):
        """multistep (with heads) and multistep_reg: the forward
        replication loss mean_i E(Y_i + Σ_{j≥i} toAdd_j − g(X_N))², a mean
        over steps and paths."""
        model, dt = self.model, self.model.dt
        heads = self.with_heads
        b = exo.hq.shape[1]
        hs = s = torch.full((b,), model.S0, device=exo.hq.device)
        pair = self._pair_heads(params)

        def body(carry, i):
            hs, s = carry
            h_out, f_out = self._heads(pair, exo, i, hs, s)
            hy, y = h_out[..., 0], f_out[..., 0]
            add_hat = -dt * model.f(hs)
            add = -dt * model.f(s)
            if heads:
                dw0, dw, dpi = exo.dw0[i], exo.dw[i], exo.dpi[i]
                add_hat = (add_hat + h_out[..., 1] * dw0
                           + h_out[..., 2] * dpi)
                add = (add + f_out[..., 1] * dw0 + f_out[..., 2] * dpi
                       + f_out[..., 3] * dw)
            hs, s = self._advance(exo, i, hs, s, hy, y)
            return (hs, s), (hy, y, add_hat, add)

        (hs, s), (hys, ys, adds_hat, adds) = self._scan(body, (hs, s))
        fwd_hat = hys + _suffix_sum(adds_hat)
        fwd = ys + _suffix_sum(adds)
        return (torch.mean(torch.square(fwd_hat - model.g(hs)[None])),
                torch.mean(torch.square(fwd - model.g(s)[None])))

    def _pair_sumlocal(self, params, exo: Exogenous):
        """sumlocal (with heads) and sumlocal_reg: the one-step residual
        loss Σ_i E(Y_{i+1} − Y_i + toAdd_i)², Y_{i+1} the head at the next
        state and g(X_N) at the last.  The carry holds Y apart from the
        head's other columns: the JAX package writes Y_{i+1} into column 0
        of the carried head output, which changes it at the last step only,
        where the carry is not read again."""
        model, dt, n = self.model, self.model.dt, self.model.N
        heads = self.with_heads
        b = exo.hq.shape[1]
        hs = s = torch.full((b,), model.S0, device=exo.hq.device)
        pair = self._pair_heads(params)
        h_out, f_out = self._heads(pair, exo, 0, hs, s)
        hy, y = h_out[..., 0], f_out[..., 0]

        def body(carry, i):
            hs, s, hy, y, h_out, f_out = carry
            add_hat = dt * model.f(hs)
            add = dt * model.f(s)
            if heads:
                dw0, dw, dpi = exo.dw0[i], exo.dw[i], exo.dpi[i]
                add_hat = (add_hat - h_out[..., 1] * dw0
                           - h_out[..., 2] * dpi)
                add = (add - f_out[..., 1] * dw0 - f_out[..., 2] * dpi
                       - f_out[..., 3] * dw)
            hs, s = self._advance(exo, i, hs, s, hy, y)
            if i == n - 1:
                hy_next, y_next = model.g(hs), model.g(s)
            else:
                h_out, f_out = self._heads(pair, exo, i + 1, hs, s)
                hy_next, y_next = h_out[..., 0], f_out[..., 0]
            err_hat = torch.mean(torch.square(hy_next - hy + add_hat))
            err = torch.mean(torch.square(y_next - y + add))
            return (hs, s, hy_next, y_next, h_out, f_out), (err_hat, err)

        _, (errs_hat, errs_full) = self._scan(
            body, (hs, s, hy, y, h_out, f_out))
        return torch.sum(errs_hat), torch.sum(errs_full)

    # ------------------------------------------------------------- training
    def warm_start_y0(self, params: dict, generator: torch.Generator,
                      batch: int = 16384, n_picard: int = 24) -> dict:
        """Params with the two trainable scalars set to fictitious-play
        averaged Picard Monte-Carlo estimates of the BSDE initial values,
        Y0_hat ≈ E[g(hS_N) + Σ_i dt·f(hS_i)], Y0 ≈ E[g(S_N) + Σ_i dt·f(S_i)],
        on noise drawn on ``generator``; everything else untouched.

        The forward controls depend on the adjoint states, so the estimate
        iterates on deterministic per-step mean-Y tables: roll the forward
        system feeding hY_i/Y_i from the previous iterate's (N + 1,) tables,
        rebuild them as table[i] = E[g(X_N)] + dt·Σ_{s≥i} E[f(X_s)], and
        average, tab_{k+1} = tab_k + (Φ(tab_k) − tab_k)/(k + 1) (the raw
        Picard map diverges at the comparison configuration).  The noise is
        frozen across iterates.  Global scheme only."""
        return self.warm_start_y0_from_noise(
            params, self._prenoise(generator, batch), n_picard, generator)

    def warm_start_y0_from_noise(self, params: dict, noise,
                                 n_picard: int = 24,
                                 generator: Optional[torch.Generator] = None
                                 ) -> dict:
        """``warm_start_y0`` on given noise (``exogenous``'s forms)."""
        if self.scheme != "global":
            raise ValueError(
                f"scheme {self.scheme!r} has no trainable y0 to warm-start")
        model, n, dt = self.model, self.model.N, self.model.dt
        with torch.no_grad():
            exo = self.exogenous(noise, generator)
            b = exo.hq.shape[1]
            hy_tab = torch.zeros((n + 1,), device=exo.hq.device)
            y_tab = torch.zeros((n + 1,), device=exo.hq.device)
            for k in range(1, n_picard + 1):
                hs = s = torch.full((b,), model.S0, device=exo.hq.device)
                mfh, mff = [], []
                for i in range(n):
                    mfh.append(torch.mean(model.f(hs)))
                    mff.append(torch.mean(model.f(s)))
                    hs, s = self._advance(exo, i, hs, s, hy_tab[i], y_tab[i])
                gh = torch.mean(model.g(hs))
                gf = torch.mean(model.g(s))
                hy_new = torch.cat([gh + dt * _suffix_sum(torch.stack(mfh)),
                                    gh[None]])
                y_new = torch.cat([gf + dt * _suffix_sum(torch.stack(mff)),
                                   gf[None]])
                w = 1.0 / (k + 1)
                hy_tab = (1.0 - w) * hy_tab + w * hy_new
                y_tab = (1.0 - w) * y_tab + w * y_new
        out = {"hat": dict(params["hat"]), "full": dict(params["full"])}
        for side, tab in (("hat", hy_tab), ("full", y_tab)):
            old = params[side]["y0"]
            out[side]["y0"] = tab[0].to(old.device, old.dtype)
        return out

    def y0_estimates(self, params) -> Tuple[torch.Tensor, torch.Tensor]:
        """(Y0_hat, Y0): the trainable scalars for global, else the heads'
        values at the initial state."""
        if self.scheme == "global":
            return params["hat"]["y0"], params["full"]["y0"]
        state = self.model.init_state(1, params["hat"]["W"][0].device)
        return self._hat(params, state)[0, 0], self._full(params, state)[0, 0]

    def train(self, seed: int, batch: int, batch_val: int, num_epoch: int,
              num_epoch_ext: int, lrate, couplage: str = "ON",
              verbose: bool = True, on_epoch=None, mesh=None,
              y0_warm_start: bool = False) -> "MFGTrainResult":
        """Train both nets from ``seed``: returns the (Y0_hat, Y0)
        histories and the trained params.  The nets come from the CPU
        generator of (seed, 0), the warm start (global scheme only) from
        (seed, 2) on ``device``, the training noise through ``fit`` from
        ``seed`` (couplage OFF: its second phase from a seed derived from
        (seed, 3)).  ``on_epoch`` is ``fit``'s hook.  Under ``mesh`` both
        phases train data-parallel: ``batch`` and ``batch_val`` stay the
        global path counts, each data rank rolling out its
        ``per_shard_batch`` of them, and rank 0's initial params (warm
        start included) are every rank's."""
        if couplage not in ("ON", "OFF"):
            raise ValueError(f"couplage must be ON|OFF, got {couplage!r}")
        verbose = verbose and (mesh is None or mesh.rank == 0)
        params = self.init_params(make_generator("cpu", seed, 0))
        if y0_warm_start and self.scheme == "global":
            params = self.warm_start_y0(
                params, make_generator(self.device, seed, 2))
            if verbose:
                print(f"warm-started Y0_hat={float(params['hat']['y0']):.4f}"
                      f" Y0={float(params['full']['y0']):.4f}")
        if mesh is not None:
            # the net a phase freezes is rank 0's too
            broadcast_params(params, mesh)
            batch = per_shard_batch(batch, mesh)
            batch_val = per_shard_batch(batch_val, mesh)
        pair_train = self.build_pair_loss(batch)
        pair_val = self.build_pair_loss(batch_val)
        common = dict(lrate=lrate, num_epoch=num_epoch,
                      num_epoch_ext=num_epoch_ext, verbose=verbose,
                      on_epoch=on_epoch, mesh=mesh)
        if couplage == "ON":
            def summed(pair):
                def loss(p, g):
                    loss_hat, loss_full = pair(p, g)
                    return loss_hat + loss_full
                return loss

            res = fit(loss_fn=summed(pair_train), params=params, seed=seed,
                      val_loss_fn=summed(pair_val),
                      y0_fn=self.y0_estimates, **common)
            return MFGTrainResult(
                params=res.params,
                y0_hat_history=[y[0] for y in res.y0_history],
                y0_history=[y[1] for y in res.y0_history],
                loss_history=res.loss_history)
        # phase 1: the hat net alone on the hat loss, the full net frozen
        full_frozen = params["full"]

        def with_full(p_hat):
            return {"hat": p_hat, "full": full_frozen}

        res1 = fit(loss_fn=lambda p, g: pair_train(with_full(p), g)[0],
                   params=params["hat"], seed=seed,
                   val_loss_fn=lambda p, g: pair_val(with_full(p), g)[0],
                   y0_fn=lambda p: self.y0_estimates(with_full(p))[0],
                   **common)
        hat_frozen = _detached(res1.params)

        def with_hat(p_full):
            return {"hat": hat_frozen, "full": p_full}

        # phase 2: the full net with the hat net frozen
        seed2 = int(np.random.SeedSequence([seed, 3]).generate_state(1)[0])
        res2 = fit(loss_fn=lambda p, g: pair_train(with_hat(p), g)[1],
                   params=params["full"], seed=seed2,
                   val_loss_fn=lambda p, g: pair_val(with_hat(p), g)[1],
                   y0_fn=lambda p: self.y0_estimates(with_hat(p))[1],
                   **common)
        return MFGTrainResult(
            params={"hat": hat_frozen, "full": res2.params},
            y0_hat_history=res1.y0_history, y0_history=res2.y0_history,
            loss_history=res1.loss_history + res2.loss_history)

    # ------------------------------------------------------------ evaluators
    def policy_states(self, params, exo: Exogenous):
        """Yields (i, hS, S, hY, Y) for i = 0…N along the trained policy:
        the global scheme rolls hY/Y by its BSDE from the scalars, the
        others read them from the heads at each state."""
        model, dt = self.model, self.model.dt
        b = exo.hq.shape[1]
        hs = s = torch.full((b,), model.S0, device=exo.hq.device)
        is_global = self.scheme == "global"
        pair = self._pair_heads(params)
        if is_global:
            ones = torch.ones((b,), device=exo.hq.device)
            hy, y = params["hat"]["y0"] * ones, params["full"]["y0"] * ones
        else:
            h_out, f_out = self._heads(pair, exo, 0, hs, s)
            hy, y = h_out[..., 0], f_out[..., 0]
        for i in range(model.N):
            yield i, hs, s, hy, y
            if is_global:
                hy_next, y_next = self._bsde_step(pair, exo, i, hs, s, hy,
                                                  y)
            hs, s = self._advance(exo, i, hs, s, hy, y)
            if not is_global:
                h_out, f_out = self._heads(pair, exo, i + 1, hs, s)
                hy_next, y_next = h_out[..., 0], f_out[..., 0]
            hy, y = hy_next, y_next
        yield model.N, hs, s, hy, y

    def simulate_global_err(self, params, generator: torch.Generator,
                            batch: int):
        """Expected running + terminal cost of both BSDEs and the terminal
        mismatch, on noise drawn on ``generator``: (cost_hat, cost, err)."""
        return self.simulate_global_err_from_noise(
            params, self._prenoise(generator, batch), generator)

    def simulate_global_err_from_noise(self, params, noise, generator=None):
        """``simulate_global_err`` on given noise."""
        model, dt = self.model, self.model.dt
        with torch.no_grad():
            exo = self.exogenous(noise, generator)
            cost_hat = cost = torch.zeros_like(exo.hq[0])
            for i, hs, s, hy, y in self.policy_states(params, exo):
                if i < model.N:
                    cost_hat = cost_hat + dt * model.f(hs)
                    cost = cost + dt * model.f(s)
            cost_hat = cost_hat + model.g(hs)
            cost = cost + model.g(s)
            err = (torch.mean(torch.square(hy - model.g(hs)))
                   + torch.mean(torch.square(y - model.g(s))))
            return torch.mean(cost_hat), torch.mean(cost), err

    def follow_s(self, params, generator: torch.Generator, batch: int):
        """Mean and population std trajectories of hS and S under the
        trained policy: 4 tensors of shape (N + 1,)."""
        return self.follow_s_from_noise(
            params, self._prenoise(generator, batch), generator)

    def follow_s_from_noise(self, params, noise, generator=None):
        """``follow_s`` on given noise."""
        with torch.no_grad():
            exo = self.exogenous(noise, generator)
            stats = [(torch.mean(hs), torch.std(hs, correction=0),
                      torch.mean(s), torch.std(s, correction=0))
                     for _, hs, s, _, _ in self.policy_states(params, exo)]
            return tuple(torch.stack(c) for c in zip(*stats))


@dataclasses.dataclass
class MFGTrainResult:
    params: dict
    y0_hat_history: list
    y0_history: list
    loss_history: list

    def __iter__(self):
        # the reference returns (listY0_hat, listY0)
        return iter((self.y0_hat_history, self.y0_history))
