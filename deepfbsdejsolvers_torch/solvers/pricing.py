"""Deep-BSDE pricing solver: the global scheme with hoisted tables.

The global scheme trains a scalar Y0 and the Γ and Z heads against the
terminal loss E(Y_N − g(X_N))².  One step of the loss:

1. all noise is drawn up front, dW and J as (N, B) tensors (``_prenoise``);
2. the per-step tables are built outside the time loop (``_hoist_tables``):
   each step's spot interval comes from the uncoupled log-increments of the
   drawn noise, and the compensator E_J[Γ] (quadrature over the jump law),
   the collocated price A(i, x) and the Z head are fitted on it;
3. the coupled N-step rollout reads the tables and evaluates Γ at the
   realized jump (``ops/rollout.py``): step by step in PyTorch, or with
   ``fused_rollout=True`` as the B1/B2 CUDA kernels on the card.

The time feature fed to the nets is the raw step index i (times
``time_scale``), not i·dt, as in the reference.

Only this configuration is ported so far.  The other six schemes, the
un-hoisted in-body sweep, the Monte-Carlo compensator, the 2-D Γ tables, the
hand-written adjoint, bf16 heads and compensator sharding raise
NotImplementedError (ROADMAP Queue 1).  ``scan_chunk`` and ``remat`` are
accepted and ignored: they shape the JAX package's XLA scan, and the port
has no scan.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Tuple

import torch

from deepfbsdejsolvers_torch.nets.mlp import (
    MLPSpec, get_activation, init_mlp, mlp_apply)
from deepfbsdejsolvers_torch.ops.chebyshev import _cheb_tables_on, cheb_fit
from deepfbsdejsolvers_torch.ops.compensator import (
    CompensatorSpec, compensated_mean)
from deepfbsdejsolvers_torch.ops.numerics import use_full_f32
from deepfbsdejsolvers_torch.ops.piecewise import pw_fit, pw_nodes
from deepfbsdejsolvers_torch.ops.rollout import (
    KERNEL_COEFFS, KERNEL_WIDTHS, FusedRolloutOp, merton_form_constants,
    rollout_plain)

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
    """

    model: object
    scheme: str
    hidden: Tuple[int, ...] = (21, 21)
    activation: str = "tanh"
    compensator: CompensatorSpec = CompensatorSpec()
    remat: bool = True            # accepted, ignored: no scan to remat
    compute_dtype: Optional[str] = None
    sweep_impl: str = "xla"       # "xla": the plain PyTorch sweep
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
        if self.compensator.x_interp != "chebyshev":
            raise NotImplementedError(
                "the direct per-path compensator sweep (parity config) "
                f"{_NOT_PORTED}, item 6; use x_interp='chebyshev', hoist=True")
        if not self.hoist:
            raise NotImplementedError(
                f"the un-hoisted in-body sweep {_NOT_PORTED}, item 6; pass "
                "hoist=True")
        unported = {
            "compensator.kind='mc'": self.compensator.kind == "mc",
            "sweep_impl='pallas' (kernels B3/B4, ROADMAP Queue 2)":
                self.sweep_impl != "xla",
            "comp_axis sharding": self.comp_axis is not None,
            "compute_dtype": self.compute_dtype is not None,
            "hoist_gamma": self.hoist_gamma,
            "adjoint": self.adjoint,
            "hoist_z=False": not self.hoist_z,
            "price_mode != 'chebyshev'": not self._price_collocated(),
        }
        for what, hit in unported.items():
            if hit:
                raise NotImplementedError(f"{what} {_NOT_PORTED}")
        if self.fused_rollout:
            reasons = self.fused_unmet()
            if reasons:
                raise ValueError("fused_rollout=True precondition not met: "
                                 + "; ".join(reasons))
        use_full_f32()
        nodes, weights = self.model.jump_quadrature(self.compensator)
        dev = torch.device(self.device)
        object.__setattr__(self, "_quad", (nodes.to(dev), weights.to(dev)))
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
        weighted node sweep; ``i`` broadcasts against ``x_pts``."""
        i = torch.as_tensor(i, device=x_pts.device)[..., None, None]
        sweep = self._apply(params["gam"], self._gamma_inputs(
            i, x_pts[..., None, :], nodes[:, None]))[..., 0]      # (..., M, C)
        return compensated_mean(sweep.movedim(-2, 0), weights)

    # ---------------------------------------------------------------- noise
    def _prenoise(self, generator: torch.Generator, batch: int):
        """All rollout noise at once: dW (N, B) Brownian increments and J
        (N, B) realized jumps, on the generator's device."""
        n, dt = self.model.N, self.model.dt
        dw = math.sqrt(dt) * torch.randn((n, batch), generator=generator,
                                         device=generator.device)
        j = self.model.sample_jumps(generator, (n, batch))
        return dw, j

    # ------------------------------------------------- hoisted collocation
    def _hoist_tables(self, params, noise) -> dict:
        """Per-step tables {"lo", "hi", "cc", "pc", "zc"} built outside the
        time loop.  The intervals come from the exact uncoupled X marginals
        of the drawn noise, padded in log space by ``hoist_pad_frac``; the
        coupling drift the intervals ignore is covered by the pad and the
        evaluators' boundary clamp."""
        model, n = self.model, self.model.N
        dw, j = noise
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
        qn, qw = self._quad
        return {
            "lo": lo, "hi": hi,
            "cc": fit(self._sweep_comp_at(params, steps[:, 0], nodes, qn,
                                          qw)),
            "pc": fit(model.price(steps, nodes)),
            "zc": fit(self._uz(params, steps, nodes)[..., 0]),
        }

    # --------------------------------------------------------------- global
    def fused_unmet(self) -> List[str]:
        """The unmet preconditions of the fused rollout kernels (empty when
        they apply): the hoisted piecewise path, a Merton-form model, two
        equal tanh hidden layers of a width the kernels are built for, and
        degree-7 tables."""
        h = self.hidden
        reasons = []
        if not self.hoist or self.hoist_interp != "piecewise":
            reasons.append("needs hoist=True and hoist_interp='piecewise'")
        if self.activation != "tanh":
            reasons.append(f"activation {self.activation!r} != 'tanh'")
        if not (len(h) == 2 and h[0] == h[1] and h[0] in KERNEL_WIDTHS):
            reasons.append(f"hidden {tuple(h)} must be two equal layers of a "
                           f"width in {KERNEL_WIDTHS}")
        if self.pw_degree + 1 != KERNEL_COEFFS:
            reasons.append(f"pw_degree {self.pw_degree} != "
                           f"{KERNEL_COEFFS - 1}")
        if merton_form_constants(self.model) is None:
            reasons.append("the model is not of Merton form "
                           "(merton_form_constants)")
        return reasons

    def _rollout(self) -> Callable:
        if self.fused_rollout:
            return FusedRolloutOp(self.model, self.hidden[0],
                                  time_scale=self.time_scale,
                                  n_pieces=self.pw_pieces,
                                  degree=self.pw_degree)
        return lambda gp, y0, tables, dw, j: rollout_plain(
            self.model, gp, y0, tables, dw, j, self.time_scale, self._act)

    def build_loss_from_noise(self, batch: int) -> Callable:
        """``loss(params, (dw, j))`` on given (N, batch) noise tensors, so
        that the same noise can drive this solver and another
        implementation."""
        model, n = self.model, self.model.N
        roll = self._rollout()

        def loss(params, noise):
            dw, j = noise
            if tuple(dw.shape) != (n, batch) or tuple(j.shape) != (n, batch):
                raise ValueError(f"noise must be ({n}, {batch}), got "
                                 f"{tuple(dw.shape)} and {tuple(j.shape)}")
            tables = self._hoist_tables(params, (dw, j))
            x_n, y_n = roll(params["gam"], params["uz"]["y0"], tables, dw, j)
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
