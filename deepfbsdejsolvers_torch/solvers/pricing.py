"""Deep-BSDE pricing solver: the global scheme, hoisted or per step.

The global scheme trains a scalar Y0 and the Γ and Z heads against the
terminal loss E(Y_N − g(X_N))².  All noise is drawn up front (``_prenoise``):
dW and J as (N, B) tensors, and with the Monte-Carlo compensator the (N,
n_mc) node draws of every step.  Then one of two rollouts:

* hoisted (``hoist=True``): the per-step tables are built outside the time
  loop (``_hoist_tables``) — each step's spot interval comes from the
  uncoupled log-increments of the drawn noise, and the compensator E_J[Γ],
  the collocated price A(i, x) and the Z head are fitted on it — and the
  coupled N-step rollout reads them (``ops/rollout.py``): step by step in
  PyTorch, or with ``fused_rollout=True`` as the B1/B2 CUDA kernels;
* per step (``hoist=False``, the reference-faithful parity path): every
  step evaluates Γ at the realized jump and Z by the heads, A(i, x) by the
  model's pricer, and the compensator by sweeping the Γ head over the node
  set for every path (``x_interp="direct"``) or at ``n_cheb`` collocation
  points (``"chebyshev"``).  With ``sweep_impl="pallas"`` the direct sweep
  runs in the rank-1 form of ``ops/sweep.py``: on the card as the B3/B4
  CUDA kernels.

The time feature fed to the nets is the raw step index i (times
``time_scale``), not i·dt, as in the reference.

Only the global scheme of the jump-diffusion regime is ported so far.  The
other six schemes, the 2-D Γ tables, the hand-written adjoint, bf16 heads
and compensator sharding raise NotImplementedError (ROADMAP Queue 1).
``scan_chunk`` is accepted and ignored: it shapes the JAX package's XLA
scan, and the port has no scan.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from deepfbsdejsolvers_torch.nets.mlp import (
    MLPSpec, get_activation, init_mlp, mlp_apply)
from deepfbsdejsolvers_torch.ops.chebyshev import (
    _cheb_tables_on, cheb_fit, interp_1d)
from deepfbsdejsolvers_torch.ops.compensator import (
    CompensatorSpec, compensated_mean)
from deepfbsdejsolvers_torch.ops.numerics import use_full_f32
from deepfbsdejsolvers_torch.ops.piecewise import pw_fit, pw_nodes
from deepfbsdejsolvers_torch.ops.rollout import (
    KERNEL_COEFFS, KERNEL_WIDTHS, FusedRolloutOp, merton_form_constants,
    rollout_plain)
from deepfbsdejsolvers_torch.ops.sweep import fused_sweep, rank1_three_feature

PRICING_SCHEMES = ("global", "multistep1", "multistep2", "sumlocal1",
                   "sumlocal2", "sumlocal_reg", "multistep_reg")

Params = Dict[str, dict]

_NOT_PORTED = "is not ported yet (ROADMAP Queue 1)"


@dataclasses.dataclass(frozen=True)
class PricingSolver:
    """Builds ``loss(params, generator)`` closures for one (model, scheme).

    The fields mirror the JAX package's ``solvers/pricing.PricingSolver`` so
    that a configuration carries across; see the module docstring for
    what is ported.  ``device`` is where parameters, noise and tables live.

    ``sweep_impl`` keeps the JAX names: "xla" sweeps the Γ MLP in plain
    PyTorch; "pallas" sweeps its rank-1 form (``ops/sweep.py``), which on
    CUDA tensors runs the CUDA kernels B3 (forward) and B4 (backward) and on
    CPU tensors their plain version.  It reaches the per-step direct sweep
    and the hoisted Monte-Carlo table build, as in the JAX package.
    ``remat`` runs each step's plain sweep under ``torch.utils.checkpoint``,
    so that only its (B,) output persists until the backward.
    """

    model: object
    scheme: str
    hidden: Tuple[int, ...] = (21, 21)
    activation: str = "tanh"
    compensator: CompensatorSpec = CompensatorSpec()
    remat: bool = True
    compute_dtype: Optional[str] = None
    sweep_impl: str = "xla"
    comp_axis: Optional[str] = None
    hoist: bool = False
    hoist_pad_frac: float = 0.15
    hoist_interp: str = "clenshaw"
    pw_pieces: int = 8
    pw_degree: int = 7
    hoist_z: bool = True
    hoist_gamma: bool = False
    scan_chunk: int = 0           # accepted, ignored: no scan to chunk
    adjoint: bool = False
    fused_rollout: bool = False
    time_scale: float = 1.0
    device: str = "cuda"

    def __post_init__(self):
        if self.scheme not in PRICING_SCHEMES:
            raise ValueError(f"scheme must be one of {PRICING_SCHEMES}, got "
                             f"{self.scheme!r}")
        if self.model.regime != "jump_diffusion":
            raise NotImplementedError(
                f"regime {self.model.regime!r} {_NOT_PORTED}, item 10")
        if self.scheme != "global":
            raise NotImplementedError(
                f"scheme {self.scheme!r} {_NOT_PORTED}, item 9")
        if self.hoist_interp not in ("piecewise", "clenshaw"):
            raise ValueError("hoist_interp must be 'piecewise' or "
                             f"'clenshaw', got {self.hoist_interp!r}")
        if self.sweep_impl not in ("xla", "pallas"):
            raise ValueError("sweep_impl must be 'xla' or 'pallas', got "
                             f"{self.sweep_impl!r}")
        if self.hoist and self.compensator.x_interp != "chebyshev":
            raise ValueError("hoist=True requires compensator.x_interp="
                             "'chebyshev' (the hoisted tables are the "
                             "collocation)")
        unmet = {
            "fused_rollout=True": self.fused_rollout and self.fused_unmet(),
            "sweep_impl='pallas'":
                self.sweep_impl == "pallas" and self.sweep_unmet(),
        }
        for flag, reasons in unmet.items():
            if reasons:
                raise ValueError(f"{flag} precondition not met: "
                                 + "; ".join(reasons))
        unported = {
            "comp_axis sharding": self.comp_axis is not None,
            "compute_dtype": self.compute_dtype is not None,
            "hoist_gamma": self.hoist_gamma,
            "adjoint": self.adjoint,
            "hoist_z=False with hoist=True": self.hoist and not self.hoist_z,
            "price_mode != 'chebyshev' with hoist=True":
                self.hoist and not self._price_collocated(),
        }
        for what, hit in unported.items():
            if hit:
                raise NotImplementedError(f"{what} {_NOT_PORTED}")
        use_full_f32()
        quad = (None, None)
        if self.compensator.kind == "quadrature":
            dev = torch.device(self.device)
            quad = tuple(t.to(dev) for t in
                         self.model.jump_quadrature(self.compensator))
        object.__setattr__(self, "_quad", quad)
        object.__setattr__(self, "_act", get_activation(self.activation))

    # ------------------------------------------------------------------ nets
    def _price_collocated(self) -> bool:
        return getattr(self.model, "price_mode", None) == "chebyshev"

    def net_specs(self) -> Dict[str, MLPSpec]:
        """UZ net carries Y0 and outputs Z; the Γ net takes (t, X, J)."""
        h, a = self.hidden, self.activation
        return {"uz": MLPSpec(2, h, 1, a, with_y0=True),
                "gam": MLPSpec(3, h, 1, a)}

    def init_params(self, generator: torch.Generator) -> Params:
        """Glorot-normal heads drawn from a CPU ``generator``, on
        ``self.device``."""
        return {name: init_mlp(generator, spec, self.device)
                for name, spec in self.net_specs().items()}

    def _apply(self, p, cols) -> torch.Tensor:
        return mlp_apply(p, cols, self._act)

    def _time(self, i, like: torch.Tensor) -> torch.Tensor:
        """The time feature: raw step index × time_scale, broadcast."""
        return torch.as_tensor(i, dtype=like.dtype,
                               device=like.device) * self.time_scale

    def _uz(self, params, i, x):
        """U/Z head on [t=i, X]; ``i`` broadcasts against ``x``."""
        t = torch.broadcast_to(self._time(i, x), x.shape)
        return self._apply(params["uz"], torch.stack([t, x], -1))

    def _gamma_inputs(self, i, x, j):
        """Γ-head inputs (t, X, J) broadcast to one shape."""
        t = self._time(i, x)
        t, xb, jb = torch.broadcast_tensors(t, x, j)
        return torch.stack([t, xb, jb], -1)

    def _sweep_comp_at(self, params, i, x_pts, nodes, weights):
        """E_J[Γ(t, x, J)] at spot points ``x_pts`` (..., C) by the
        weighted node sweep; ``i`` broadcasts against ``x_pts``, and
        ``nodes`` is one (M,) set or one set per leading index (..., M)."""
        i = torch.as_tensor(i, device=x_pts.device)[..., None, None]
        sweep = self._apply(params["gam"], self._gamma_inputs(
            i, x_pts[..., None, :], nodes[..., :, None]))[..., 0]  # (..., M, C)
        return compensated_mean(sweep.movedim(-2, 0), weights)

    # ----------------------------------------------------- compensator sweep
    def _remat(self, fn):
        """``fn()``, under ``torch.utils.checkpoint`` when ``remat`` is on
        and autograd records: only its output persists until the backward,
        which recomputes it."""
        if self.remat and torch.is_grad_enabled():
            return checkpoint(fn, use_reentrant=False)
        return fn()

    def _resolve_node_block(self, n_nodes: int, batch: int) -> Optional[int]:
        """Node-axis chunk of the plain direct sweep
        (``CompensatorSpec.node_block``): auto keeps one block's [block, B,
        H] activations near 1 GB and is a no-op for small sweeps."""
        block = self.compensator.node_block
        if block is None:
            block = max(1, (1 << 24) // max(batch, 1))
        if block <= 0 or block >= n_nodes:
            return None
        return int(block)

    def _sweep_mean(self, params, i, x, nodes, weights) -> torch.Tensor:
        """E_J[Γ(t, x_b, J)] for every path by the plain sweep of the Γ MLP
        over the node set.  Above the node block it sums per-block weighted
        partials, each block rematerialized, so the backward replays one
        block at a time and peak memory is O(block·B)."""
        m = int(nodes.shape[0])
        block = self._resolve_node_block(m, int(x.shape[0]))
        if block is None:
            return self._remat(lambda: self._sweep_comp_at(params, i, x,
                                                           nodes, weights))
        n_blocks = -(-m // block)
        pad = n_blocks * block - m
        # uniform MC weights become explicit, so zero-weight padding is exact
        w = torch.full_like(nodes, 1.0 / m) if weights is None else weights
        nodes = torch.nn.functional.pad(nodes, (0, pad))
        w = torch.nn.functional.pad(w, (0, pad))
        blk = lambda nd, wt: self._sweep_comp_at(params, i, x, nd, wt)
        return sum(checkpoint(blk, nd, wt, use_reentrant=False) for nd, wt in
                   zip(nodes.view(n_blocks, block), w.view(n_blocks, block)))

    def _rank1_sweep_mean(self, params, i, x, nodes, weights) -> torch.Tensor:
        """The same expectation through the rank-1 sweep (``ops/sweep.py``):
        kernels B3/B4 on CUDA tensors, their plain version on CPU tensors.
        ``weights=None`` means uniform (the Monte-Carlo node set)."""
        if weights is None:
            weights = torch.full_like(nodes, 1.0 / nodes.shape[0])
        gam = params["gam"]
        a, c, v, wb2 = rank1_three_feature(gam, self._time(i, x), nodes,
                                           False, weights)
        return fused_sweep(x, a, c, gam["W"][1], gam["b"][1], v) + wb2

    def _gamma_and_compensator(self, params, i, x, j, mc_nodes):
        """Γ(t, X, J) at the realized jump and its compensator E_J'[Γ] for
        one un-hoisted step, both (B,).  The compensator sweeps the step's
        Monte-Carlo draws ``mc_nodes`` (uniform weights) or the quadrature,
        at every path or at ``n_cheb`` collocation points."""
        gam = self._apply(params["gam"], self._gamma_inputs(i, x, j))[..., 0]
        spec = self.compensator
        nodes, weights = ((mc_nodes, None) if spec.kind == "mc"
                          else self._quad)
        if spec.x_interp == "chebyshev":
            comp = interp_1d(
                lambda xn: self._sweep_comp_at(params, i, xn, nodes, weights),
                x, spec.n_cheb, robust_sigmas=spec.cheb_robust_sigmas)
        elif self.sweep_impl == "pallas":
            sweep = lambda: self._rank1_sweep_mean(params, i, x, nodes,
                                                   weights)
            # B4 recomputes the sweep itself; the plain version on the CPU
            # is rematerialized like the XLA sweep
            comp = sweep() if x.is_cuda else self._remat(sweep)
        else:
            comp = self._sweep_mean(params, i, x, nodes, weights)
        return gam, comp

    # ---------------------------------------------------------------- noise
    def _prenoise(self, generator: torch.Generator, batch: int):
        """All rollout noise at once, on the generator's device: dW (N, B)
        Brownian increments, J (N, B) realized jumps, and with the
        Monte-Carlo compensator the (N, n_mc) node draws of every step."""
        n, dt = self.model.N, self.model.dt
        dw = math.sqrt(dt) * torch.randn((n, batch), generator=generator,
                                         device=generator.device)
        j = self.model.sample_jumps(generator, (n, batch))
        if self.compensator.kind == "mc":
            return dw, j, self.model.sample_jumps(
                generator, (n, self.compensator.n_mc))
        return dw, j

    def _check_noise(self, noise, batch: int) -> None:
        n, mc = self.model.N, self.compensator.kind == "mc"
        want = [(n, batch), (n, batch)] + ([(n, self.compensator.n_mc)]
                                           if mc else [])
        got = [tuple(t.shape) for t in noise]
        if got != want:
            raise ValueError(f"noise must be (dw, j{', mc_nodes' if mc else ''}"
                             f") of shapes {want}, got {got}")

    # ------------------------------------------------- hoisted collocation
    def _hoist_tables(self, params, noise) -> dict:
        """Per-step tables {"lo", "hi", "cc", "pc", "zc"} built outside the
        time loop.  The intervals come from the exact uncoupled X marginals
        of the drawn noise, padded in log space by ``hoist_pad_frac``; the
        coupling drift the intervals ignore is covered by the pad and the
        evaluators' boundary clamp.  The compensator sweeps the quadrature,
        or each step's Monte-Carlo draws (through the rank-1 sweep under
        ``sweep_impl="pallas"``, one call per step, as in the JAX
        package)."""
        model, n = self.model, self.model.N
        dw, j = noise[0], noise[1]
        incr = model.uncoupled_log_increments(dw[:n], j[:n])
        csum = torch.cumsum(incr, dim=0)
        lx = math.log(model.x0) + torch.cat(
            [torch.zeros_like(csum[:1]), csum[:-1]], dim=0)        # x_i
        llo = lx.min(dim=1).values
        lhi = lx.max(dim=1).values
        lpad = self.hoist_pad_frac * (lhi - llo) + 0.01
        lo = torch.exp(llo - lpad).detach()
        hi = torch.exp(lhi + lpad).detach()
        if self.hoist_interp == "piecewise":
            nodes = pw_nodes(lo, hi, self.pw_pieces, self.pw_degree)
            fit = lambda v: pw_fit(v, self.pw_pieces, self.pw_degree)
        else:
            u = _cheb_tables_on(self.compensator.n_cheb, lo.device)[0]
            nodes = 0.5 * (lo + hi)[:, None] + 0.5 * (hi - lo)[:, None] * u
            fit = cheb_fit
        steps = torch.arange(n, device=lo.device)[:, None]         # (N, 1)
        if self.compensator.kind == "mc" and self.sweep_impl == "pallas":
            comp = torch.stack([
                self._rank1_sweep_mean(params, i, nodes[i], noise[2][i], None)
                for i in range(n)])
        elif self.compensator.kind == "mc":
            comp = self._sweep_comp_at(params, steps[:, 0], nodes, noise[2],
                                       None)
        else:
            comp = self._sweep_comp_at(params, steps[:, 0], nodes,
                                       *self._quad)
        return {
            "lo": lo, "hi": hi, "cc": fit(comp),
            "pc": fit(model.price(steps, nodes)),
            "zc": fit(self._uz(params, steps, nodes)[..., 0]),
        }

    # --------------------------------------------------------------- global
    def _head_unmet(self) -> List[str]:
        """Why the Γ head does not fit the CUDA kernels: they take two equal
        tanh hidden layers of a width they are built for."""
        h = self.hidden
        reasons = []
        if self.activation != "tanh":
            reasons.append(f"activation {self.activation!r} != 'tanh'")
        if not (len(h) == 2 and h[0] == h[1] and h[0] in KERNEL_WIDTHS):
            reasons.append(f"hidden {tuple(h)} must be two equal layers of a "
                           f"width in {KERNEL_WIDTHS}")
        return reasons

    def fused_unmet(self) -> List[str]:
        """The unmet preconditions of the fused rollout kernels (empty when
        they apply): the hoisted piecewise path, a Merton-form model, a
        head the kernels take, and degree-7 tables."""
        reasons = []
        if not self.hoist or self.hoist_interp != "piecewise":
            reasons.append("needs hoist=True and hoist_interp='piecewise'")
        reasons += self._head_unmet()
        if self.pw_degree + 1 != KERNEL_COEFFS:
            reasons.append(f"pw_degree {self.pw_degree} != "
                           f"{KERNEL_COEFFS - 1}")
        if merton_form_constants(self.model) is None:
            reasons.append("the model is not of Merton form "
                           "(merton_form_constants)")
        return reasons

    def sweep_unmet(self) -> List[str]:
        """The unmet preconditions of the sweep kernels B3/B4 (empty when
        they apply): a head the kernels take (the Γ head has one output),
        f32 heads, and no compensator sharding.  The JAX package warns and
        falls back to its XLA sweep on these; the port refuses them."""
        reasons = self._head_unmet()
        if self.compute_dtype is not None:
            reasons.append(f"compute_dtype {self.compute_dtype!r}: the "
                           "kernels compute in f32")
        if self.comp_axis is not None:
            reasons.append("comp_axis: the kernels sweep an unsharded node "
                           "set")
        return reasons

    def _rollout(self) -> Callable:
        if self.fused_rollout:
            return FusedRolloutOp(self.model, self.hidden[0],
                                  time_scale=self.time_scale,
                                  n_pieces=self.pw_pieces,
                                  degree=self.pw_degree)
        return lambda gp, y0, tables, dw, j: rollout_plain(
            self.model, gp, y0, tables, dw, j, self.time_scale, self._act)

    def _rollout_direct(self, params, noise):
        """(x_N, y_N) of the un-hoisted global rollout: each step's heads,
        compensator sweep and pricer evaluated in the step."""
        model, dt = self.model, self.model.dt
        dw, j = noise[0], noise[1]
        mc = noise[2] if self.compensator.kind == "mc" else None
        x = model.init_x(dw.shape[1], dw.device)
        y = params["uz"]["y0"] * torch.ones_like(x)
        for i in range(model.N):
            gam, comp = self._gamma_and_compensator(
                params, i, x, j[i], None if mc is None else mc[i])
            y = y - dt * model.f(y) + gam - comp
            y = y + self._uz(params, i, x)[..., 0] * dw[i]
            x = model.step(i, x, dw[i], j[i], y)
        return x, y

    def build_loss_from_noise(self, batch: int) -> Callable:
        """``loss(params, noise)`` on given noise tensors — (dw, j), or (dw,
        j, mc_nodes) with the Monte-Carlo compensator — so that the same
        noise can drive this solver and another implementation."""
        model = self.model
        roll = self._rollout() if self.hoist else None

        def loss(params, noise):
            self._check_noise(noise, batch)
            if self.hoist:
                x_n, y_n = roll(params["gam"], params["uz"]["y0"],
                                self._hoist_tables(params, noise), noise[0],
                                noise[1])
            else:
                x_n, y_n = self._rollout_direct(params, noise)
            return torch.mean(torch.square(y_n - model.payoff(x_n)))

        return loss

    def build_loss(self, batch: int) -> Callable:
        """``loss(params, generator)``: draws the noise on ``generator``
        (which must live on ``self.device``), then the loss above."""
        from_noise = self.build_loss_from_noise(batch)

        def loss(params, generator):
            return from_noise(params, self._prenoise(generator, batch))

        return loss

    # ------------------------------------------------------------- evaluation
    def y0_estimate(self, params: Params) -> torch.Tensor:
        """Current Y0: the trainable scalar of the global scheme."""
        return params["uz"]["y0"]
