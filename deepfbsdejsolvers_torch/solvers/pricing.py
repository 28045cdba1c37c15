"""Deep-BSDE pricing solver: the seven schemes in both noise regimes.

The BSDE is dY = −f(Y) dt [+ Z dW] + Γ dΠ̃, with Γ's compensator E_J[Γ]
evaluated by a sweep over the jump law.  The jump-diffusion regime (the
Merton model) carries the Brownian term Z dW; the pure-jump regime (the
Variance-Gamma model) has no dW and no Z.  The schemes differ in the loss
and in how Γ is parametrized:

* ``global``: a trainable scalar Y0, the terminal loss E(Y_N − g(X_N))²;
* ``multistep1/2``: the forward-replication loss
  mean_i E(Y_i + Σ_{j≥i} toAdd_j − g(X_N))², the reference's "add toAdd to
  every earlier entry" as a suffix sum, reduced by a mean over steps;
* ``sumlocal1/2``: the one-step residual loss Σ_i E(Y_{i+1} − Y_i + toAdd_i)²;
* ``multistep_reg``/``sumlocal_reg``: the same losses on Y alone.

The "1" schemes take Γ from the U-net's first output: Γ = U(t, X·e^J)[0] of
the 2-output (Y, Z) U-net in the jump-diffusion regime, Γ = U(t, X + X·J) of
the 1-output U-net in the pure-jump regime.  The "2" schemes and ``global``
carry a Γ net on (t, X, f): f = J for jump-diffusion ``global``, f = e^J for
jump-diffusion multistep2/sumlocal2, and f = X·J for all three in the
pure-jump regime, where the global scheme has no U/Z net and its Γ net
carries the trainable Y0.

All noise is drawn up front (``_prenoise``): dW and J as (rows, B) tensors
(dW of zero width (rows, 0) in the pure-jump regime),
and with the Monte-Carlo compensator the (rows, n_mc) node draws of every
step; the sumlocal schemes draw N + 1 rows, whose last feeds the heads
evaluated before the loop.  Then the time loop runs either

* hoisted (``hoist=True``): per-step tables built outside the loop
  (``_hoist_tables``) — each step's spot interval comes from the uncoupled
  log-increments of the drawn noise, and the compensator E_J[Γ], the price
  A(i, x) when the model collocates it, for jump-diffusion ``global`` the Z
  head unless ``hoist_z=False``, and with ``hoist_gamma`` (piecewise, Γ-net
  schemes) the Γ head itself as 2-D tables over (x, J) (``ops/piecewise.py``
  ``pw2_*``) are fitted on it.  The global rollout reads them in its loop
  (``_global_hoisted``, through ``ops/rollout.py``'s ``rollout_plain``, the
  kernels' reference), or with ``fused_rollout=True`` in the B1/B2 CUDA
  kernels (``ops/rollout.py``, at any width up to 128), or with
  ``adjoint=True`` through the hand-written adjoint
  (``solvers/adjoint.py``); the other schemes read them in their own
  loops.  The sumlocal tables span the x_{i+1} marginal (``shift_next``)
  and hold no price table;
* or per step (``hoist=False``, the reference-faithful parity path): every
  step evaluates the heads, A(i, x) by the model's pricer, and the
  compensator by sweeping Γ over the node set for every path
  (``x_interp="direct"``) or at ``n_cheb`` collocation points
  (``"chebyshev"``).  With ``sweep_impl="pallas"`` the direct sweep of a
  one-output head runs in the rank-1 form of ``ops/sweep.py`` (a Γ net's,
  or the pure-jump U-net's on (t, X·(1 + J))): on the card as the B3/B4
  CUDA kernels, at any width up to 128.

Reference idiosyncrasies kept on purpose: the time feature fed to the nets
is the raw step index i (times ``time_scale``), not i·dt; the sumlocal
schemes evaluate the step-(i+1) state with time feature i and carry the
jump of the row before into the next forward step.

With ``comp_axis`` (``parallel/data_parallel.py``) the un-hoisted
compensator shards its node axis over that axis of the mesh the loss is
built on (``build_loss(batch, mesh)``, as the JAX package's loss binds
the axis inside its ``shard_map``): each rank
sweeps its slice of the quadrature (padded with zero-weight nodes to a
multiple of ``comp_shards``) or of each step's Monte-Carlo draws (the
ranks of one data shard draw the same noise, so each takes its
``1/comp_shards`` of the columns), at every path (a Chebyshev compensator
too), through B3/B4 with ``sweep_impl="pallas"``; the partial sums are
summed over the axis (quadrature) or averaged (Monte-Carlo) by a
differentiable all-reduce.

Every time loop runs through ``ops/scan.py``'s ``chunked_scan``: with
``scan_chunk`` its steps are checkpointed in chunks (only a chunk's inputs
kept, the chunk replayed in the backward), and the loss and gradients are
those of the plain loop bit for bit; at 0 the loop is the
plain one, each un-hoisted sweep rematerialized on its own under
``remat``.  ``compute_dtype="bfloat16"`` runs the heads' matmuls in bf16.
"""

from __future__ import annotations

import copy
import dataclasses
import math
import warnings
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from deepfbsdejsolvers_torch.nets.mlp import (
    MLPSpec, compute_dtype_of, get_activation, init_mlp, mlp_apply)
from deepfbsdejsolvers_torch.ops.chebyshev import (
    _cheb_tables_on, cheb_fit, interp_1d)
from deepfbsdejsolvers_torch.ops.compensator import (
    CompensatorSpec, compensated_mean)
from deepfbsdejsolvers_torch.ops.numerics import tf32_allowed, use_full_f32
from deepfbsdejsolvers_torch.ops.piecewise import (
    pw2_eval, pw2_fit, pw2_nodes, pw_fit, pw_nodes)
from deepfbsdejsolvers_torch.ops.rollout import (
    KERNEL_COEFFS, ROLLOUT_MAX_WIDTH, FusedRolloutOp, head_tf32_of,
    merton_form_constants, rollout_plain, table_eval)
from deepfbsdejsolvers_torch.ops.scan import chunked_scan
from deepfbsdejsolvers_torch.ops.sweep import (
    SWEEP_MAX_WIDTH, fused_sweep, rank1_three_feature, rank1_two_feature)
from deepfbsdejsolvers_torch.parallel.data_parallel import psum
from deepfbsdejsolvers_torch.utils import profiling

PRICING_SCHEMES = ("global", "multistep1", "multistep2", "sumlocal1",
                   "sumlocal2", "sumlocal_reg", "multistep_reg")
# Schemes whose Γ is a net of its own on (t, X, f), and the regressions,
# which have no Γ and no Z.
_GAMMA_NET_SCHEMES = ("global", "multistep2", "sumlocal2")
_REGRESSIONS = ("sumlocal_reg", "multistep_reg")

Params = Dict[str, dict]

def _suffix_sum(x: torch.Tensor) -> torch.Tensor:
    """S_i = Σ_{j≥i} x_j along axis 0: the multistep accumulation."""
    return torch.flip(torch.cumsum(torch.flip(x, (0,)), 0), (0,))


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
    and the hoisted Monte-Carlo table build, as in the JAX package, for the
    schemes with a Γ net, and in the pure-jump regime for multistep1/
    sumlocal1, whose U-net has one output; in the jump-diffusion regime
    those two sweep their 2-output U-net, which the kernels do not take,
    and refuse it.
    ``remat`` runs each step's plain sweep under ``torch.utils.checkpoint``,
    so that only its (B,) output persists until the backward; with
    ``scan_chunk`` it checkpoints the time loop by chunks instead
    (``ops/scan.py``).
    ``adjoint=True`` differentiates the hoisted global jump-diffusion
    rollout by the hand-written adjoint (``solvers/adjoint.py``) where the
    JAX package's ``_adjoint_ok`` holds (``adjoint_unmet``); elsewhere the
    JAX package warns and falls back to autodiff, as the port does on the
    CPU, while on the card the port raises ``ValueError``.
    ``fused_precision`` and ``fused_head_precision`` ("highest", the
    default, or "default") are the fused rollout's precisions.  The first
    governs the JAX package's one-hot select dots; the kernels select a
    piece by its index, which no precision changes, so both values give the
    same bits.  The second is the Γ head's: "default" runs the kernels'
    head-TF32 instance (``ops/rollout.py``) and builds the tables with TF32
    allowed, as the JAX package builds them at the matching precision.
    ``comp_axis`` and ``comp_shards`` shard the compensator's node axis
    (module docstring); the loss is then built on a mesh whose
    ``comp_axis`` has ``comp_shards`` ranks, and runs on its ranks.
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
    comp_shards: int = 1
    hoist: bool = False
    hoist_pad_frac: float = 0.15
    hoist_interp: str = "clenshaw"
    pw_pieces: int = 8
    pw_degree: int = 7
    hoist_z: bool = True
    hoist_gamma: bool = False
    pw_pieces_j: int = 4
    pw_degree_j: int = 4
    scan_chunk: int = 0
    adjoint: bool = False
    fused_rollout: bool = False
    fused_precision: Optional[str] = None
    fused_head_precision: Optional[str] = None
    time_scale: float = 1.0
    device: str = "cuda"

    def __post_init__(self):
        if self.scheme not in PRICING_SCHEMES:
            raise ValueError(f"scheme must be one of {PRICING_SCHEMES}, got "
                             f"{self.scheme!r}")
        if self.model.regime not in ("jump_diffusion", "pure_jump"):
            raise ValueError(f"unknown regime {self.model.regime!r}")
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
        self._check_comp_sharding()
        object.__setattr__(self, "_cdtype",
                           compute_dtype_of(self.compute_dtype))
        head_tf32_of(self.fused_precision)
        head_tf32_of(self.fused_head_precision)
        unmet = {
            "fused_rollout=True": self.fused_rollout and self.fused_unmet(),
            "sweep_impl='pallas'":
                self.sweep_impl == "pallas" and self.sweep_unmet(),
        }
        for flag, reasons in unmet.items():
            if reasons:
                raise ValueError(f"{flag} precondition not met: "
                                 + "; ".join(reasons))
        adjoint = self.adjoint and not self.fused_rollout
        if adjoint and self.adjoint_unmet():
            why = "; ".join(self.adjoint_unmet())
            if torch.device(self.device).type == "cuda":
                raise ValueError(f"adjoint=True precondition not met: {why}")
            warnings.warn(f"adjoint=True requires the fully hoisted "
                          f"piecewise global jump-diffusion path ({why}); "
                          f"falling back to autodiff")
            adjoint = False
        object.__setattr__(self, "_adjoint", adjoint)
        use_full_f32()
        quad = (None, None)
        if self.compensator.kind == "quadrature":
            dev = torch.device(self.device)
            quad = tuple(t.to(dev) for t in
                         self.model.jump_quadrature(self.compensator))
            if self.comp_axis is not None:
                # zero-weight nodes so that the count divides the shards
                pad = -quad[0].shape[0] % self.comp_shards
                quad = tuple(torch.nn.functional.pad(t, (0, pad))
                             for t in quad)
        object.__setattr__(self, "_quad", quad)
        object.__setattr__(self, "_act", get_activation(self.activation))
        object.__setattr__(self, "_mesh", None)

    def _check_comp_sharding(self) -> None:
        if self.comp_axis is None:
            return
        if self.hoist:
            raise ValueError("hoist=True is incompatible with compensator-"
                             "axis sharding (comp_axis)")
        if self.comp_shards < 1:
            raise ValueError(f"comp_shards must be positive, got "
                             f"{self.comp_shards}")
        if (self.compensator.kind == "mc"
                and self.compensator.n_mc % self.comp_shards):
            raise ValueError(f"comp_shards ({self.comp_shards}) must divide "
                             f"n_mc ({self.compensator.n_mc})")

    def _on_mesh(self, mesh) -> "PricingSolver":
        """This solver, or with ``comp_axis`` a copy bound to ``mesh``
        (whose ``comp_axis`` must have ``comp_shards`` ranks), whose
        compensator sweeps the rank's slice of the nodes."""
        if self.comp_axis is None:
            return self
        size = None if mesh is None else mesh.shape.get(self.comp_axis)
        if size != self.comp_shards:
            raise ValueError(f"comp_axis {self.comp_axis!r} with comp_shards "
                             f"{self.comp_shards} needs a mesh with that "
                             f"axis of that size (build_loss(batch, mesh)); "
                             f"got {size}")
        bound = copy.copy(self)
        object.__setattr__(bound, "_mesh", mesh)
        return bound

    # ------------------------------------------------------------------ nets
    @property
    def jump_diff(self) -> bool:
        """Whether the model has the Brownian term (else pure jumps)."""
        return self.model.regime == "jump_diffusion"

    def _price_collocated(self) -> bool:
        """Whether the model collocates its own pricer (Merton's
        ``price_mode``, the VG model's ``price_eval``)."""
        return (getattr(self.model, "price_mode", None) == "chebyshev"
                or getattr(self.model, "price_eval", None) == "chebyshev")

    @property
    def use_gam_net(self) -> bool:
        """Whether Γ is a net of its own (else the U-net's first output)."""
        return self.scheme in _GAMMA_NET_SCHEMES

    @property
    def with_heads(self) -> bool:
        """Whether the loss carries Z and Γ (all but the regressions)."""
        return self.scheme not in _REGRESSIONS

    @property
    def _y0_head(self) -> str:
        """The net carrying the global scheme's trainable Y0: the UZ net,
        or the Γ net in the pure-jump regime, which has no UZ net."""
        return "uz" if self.jump_diff else "gam"

    def net_specs(self) -> Dict[str, MLPSpec]:
        """The nets per scheme.  Jump-diffusion: ``global`` a UZ net
        carrying Y0 with output Z; multistep1/2 and sumlocal1/2 a U-net
        with outputs (Y, Z); the regressions a U-net with output Y.
        Pure-jump: no Z anywhere, so every U-net has the one output Y, and
        ``global`` has no U-net.  A Γ net on (t, X, f) for the schemes that
        carry one, with Y0 in the pure-jump global scheme."""
        h, a = self.hidden, self.activation
        specs = {}
        if self.scheme == "global":
            if self.jump_diff:
                specs["uz"] = MLPSpec(2, h, 1, a, with_y0=True)
        else:
            z_out = self.jump_diff and self.with_heads
            specs["uz"] = MLPSpec(2, h, 2 if z_out else 1, a)
        if self.use_gam_net:
            specs["gam"] = MLPSpec(3, h, 1, a, with_y0=(
                self.scheme == "global" and not self.jump_diff))
        return specs

    def init_params(self, generator: torch.Generator) -> Params:
        """Glorot-normal heads drawn from a CPU ``generator``, on
        ``self.device``."""
        return {name: init_mlp(generator, spec, self.device)
                for name, spec in self.net_specs().items()}

    def _apply(self, p, cols) -> torch.Tensor:
        return mlp_apply(p, cols, self._act, self._cdtype)

    def _time(self, i, like: torch.Tensor) -> torch.Tensor:
        """The time feature: raw step index × time_scale, broadcast."""
        return torch.as_tensor(i, dtype=like.dtype,
                               device=like.device) * self.time_scale

    def _uz(self, params, i, x):
        """U/Z head on [t=i, X]; ``i`` broadcasts against ``x``."""
        t = torch.broadcast_to(self._time(i, x), x.shape)
        return self._apply(params["uz"], torch.stack([t, x], -1))

    def _node_feature(self, j):
        """The Γ net's jump feature f per node, before any factor of X: J
        for jump-diffusion ``global``, e^J for jump-diffusion multistep2/
        sumlocal2, and J in the pure-jump regime, where f = X·J
        (``_x_prop``)."""
        if self.scheme == "global" or not self.jump_diff:
            return j
        return torch.exp(j)

    @property
    def _x_prop(self) -> bool:
        """Whether the Γ net's feature is X·``_node_feature`` (pure jump)."""
        return not self.jump_diff

    def _unet_factor(self, j):
        """φ(J) of the U-net's Γ input X·φ: e^J (jump-diffusion), 1 + J
        (pure-jump, the reference's X + X·J)."""
        return torch.exp(j) if self.jump_diff else 1.0 + j

    def _gamma_inputs(self, i, x, j):
        """Γ-net inputs (t, X, f) broadcast to one shape: f =
        ``_node_feature(J)``, times X in the pure-jump regime."""
        t, xb, fb = torch.broadcast_tensors(self._time(i, x), x,
                                            self._node_feature(j))
        if self._x_prop:
            fb = xb * fb
        return torch.stack([t, xb, fb], -1)

    def _unet_jump_inputs(self, i, x, j):
        """U-net inputs of Γ for multistep1/sumlocal1: (t, X·e^J), or
        (t, X + X·J) in the pure-jump regime."""
        t, xb, jb = torch.broadcast_tensors(self._time(i, x), x, j)
        arg = xb * torch.exp(jb) if self.jump_diff else xb + xb * jb
        return torch.stack([t, arg], -1)

    def _gamma_head(self, params, i, x, j) -> torch.Tensor:
        """Γ(t, X, J), broadcast over (i, x, j): the Γ net, or the U-net's
        first output at (t, X·e^J)."""
        if self.use_gam_net:
            return self._apply(params["gam"],
                               self._gamma_inputs(i, x, j))[..., 0]
        return self._apply(params["uz"],
                           self._unet_jump_inputs(i, x, j))[..., 0]

    def _sweep_comp_at(self, params, i, x_pts, nodes, weights):
        """E_J[Γ(t, x, J)] at spot points ``x_pts`` (..., C) by the
        weighted node sweep; ``i`` broadcasts against ``x_pts``, and
        ``nodes`` is one (M,) set or one set per leading index (..., M)."""
        i = torch.as_tensor(i, device=x_pts.device)[..., None, None]
        sweep = self._gamma_head(params, i, x_pts[..., None, :],
                                 nodes[..., :, None])         # (..., M, C)
        return compensated_mean(sweep.movedim(-2, 0), weights)

    # ----------------------------------------------------- compensator sweep
    def _remat(self, fn):
        """``fn()``, under ``torch.utils.checkpoint`` when ``remat`` is on,
        the time loop is not chunked, and autograd records: only its output
        persists until the backward, which recomputes it."""
        if self.remat and not self.scan_chunk and torch.is_grad_enabled():
            return checkpoint(fn, use_reentrant=False)
        return fn()

    def _scan(self, body, carry, n: int):
        """``chunked_scan`` of ``body(carry, i)`` over the N steps: chunks
        of ``scan_chunk`` steps checkpointed under ``remat``; the plain
        loop when ``scan_chunk`` is 0."""
        return chunked_scan(body, carry, range(n), n, self.scan_chunk,
                            remat=self.remat and bool(self.scan_chunk))

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
        """E_J[Γ(t, x_b, J)] for every path by the plain sweep of the Γ head
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
        """The same expectation through the rank-1 sweep of the swept head
        (``ops/sweep.py``): kernels B3/B4 on CUDA tensors, their plain
        version on CPU tensors.  A Γ net is swept on the node feature
        ``_node_feature`` (times X in the pure-jump regime), the pure-jump
        U-net on (t, X·(1 + J)).  ``weights=None`` means uniform (the
        Monte-Carlo node set)."""
        if weights is None:
            weights = torch.full_like(nodes, 1.0 / nodes.shape[0])
        t = self._time(i, x)
        if self.use_gam_net:
            head = params["gam"]
            a, c, v, wb2 = rank1_three_feature(head, t,
                                               self._node_feature(nodes),
                                               self._x_prop, weights)
        else:
            head = params["uz"]
            a, c, v, wb2 = rank1_two_feature(head, t,
                                             self._unet_factor(nodes),
                                             weights)
        return fused_sweep(x, a, c, head["W"][1], head["b"][1], v) + wb2

    def _comp_slice(self, nodes, weights):
        """This rank's slice of the node set on ``comp_axis``."""
        per = nodes.shape[0] // self.comp_shards
        c = self._mesh.coord(self.comp_axis)
        at = slice(per * c, per * (c + 1))
        return nodes[at], None if weights is None else weights[at]

    def _gamma_and_compensator(self, params, i, x, j, mc_nodes):
        """Γ(t, X, J) at the realized jump and its compensator E_J'[Γ] for
        one un-hoisted step, both (B,).  The compensator sweeps the step's
        Monte-Carlo draws ``mc_nodes`` (uniform weights) or the quadrature,
        at every path or at ``n_cheb`` collocation points; with
        ``comp_axis``, this rank's slice of them at every path, summed (or,
        Monte-Carlo, averaged) over the axis."""
        gam = self._gamma_head(params, i, x, j)
        spec = self.compensator
        nodes, weights = ((mc_nodes, None) if spec.kind == "mc"
                          else self._quad)
        sharded = self.comp_axis is not None
        if sharded:
            nodes, weights = self._comp_slice(nodes, weights)
        if spec.x_interp == "chebyshev" and not sharded:
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
        if sharded:
            comp = psum(comp, self._mesh, self.comp_axis)
            if weights is None:
                comp = comp / self.comp_shards
        return gam, comp

    def _heads_gamma_comp(self, params, tables, i, x, j, mc_nodes):
        """(Γ at the realized jump, compensator) of step ``i``: the
        compensator read from the hoisted tables when there are any, else
        the un-hoisted machinery."""
        if tables is None:
            return self._gamma_and_compensator(params, i, x, j, mc_nodes)
        comp = self._table_comp(tables, i, x)
        return self._table_gamma(params, tables, i, x, j), comp

    @staticmethod
    def _table_comp(tables, i, x):
        """The hoisted compensator of step ``i`` at x."""
        return table_eval(tables["cc"][i], x, tables["lo"][i],
                          tables["hi"][i])

    def _table_gamma(self, params, tables, i, x, j):
        """Γ at the realized jump on a hoisted step: the 2-D table under
        ``hoist_gamma``, else the head."""
        if "gc" not in tables:
            return self._gamma_head(params, i, x, j)
        return pw2_eval(tables["gc"][i], x, j, tables["lo"][i],
                        tables["hi"][i], tables["jlo"][i], tables["jhi"][i],
                        self.pw_pieces, self.pw_degree, self.pw_pieces_j,
                        self.pw_degree_j)

    @staticmethod
    def _step_price(tables, i, x):
        """The hoisted A(i, x) for the forward drift, or None to evaluate
        the model's own pricer."""
        if tables is None or "pc" not in tables:
            return None
        return table_eval(tables["pc"][i], x, tables["lo"][i],
                          tables["hi"][i])

    def _step_z(self, params, tables, i, x):
        """Z(i, x) of the global jump-diffusion scheme: the hoisted table,
        or the head itself under ``hoist_z=False``."""
        if "zc" in tables:
            return table_eval(tables["zc"][i], x, tables["lo"][i],
                              tables["hi"][i])
        return self._uz(params, i, x)[..., 0]

    # ---------------------------------------------------------------- noise
    @property
    def noise_rows(self) -> int:
        """Rows of noise a loss draws: N, or N + 1 for the sumlocal schemes,
        whose last row feeds the heads evaluated before the loop."""
        n = self.model.N
        return n + 1 if self.scheme.startswith("sumlocal") else n

    def _prenoise(self, generator: torch.Generator, batch: int,
                  rows: Optional[int] = None):
        """All rollout noise at once, on the generator's device: dW (rows, B)
        Brownian increments (zero-width (rows, 0) in the pure-jump regime),
        J (rows, B) realized jumps, and with the Monte-Carlo compensator the
        (rows, n_mc) node draws of every step.  ``rows`` defaults to N."""
        rows = self.model.N if rows is None else rows
        dev = generator.device
        if self.jump_diff:
            dw = math.sqrt(self.model.dt) * torch.randn(
                (rows, batch), generator=generator, device=dev)
        else:
            dw = torch.zeros((rows, 0), device=dev)
        j = self.model.sample_jumps(generator, (rows, batch))
        if self.compensator.kind == "mc":
            return dw, j, self.model.sample_jumps(
                generator, (rows, self.compensator.n_mc))
        return dw, j

    def _check_noise(self, noise, batch: int) -> None:
        n, mc = self.noise_rows, self.compensator.kind == "mc"
        want = [(n, batch if self.jump_diff else 0), (n, batch)] + (
            [(n, self.compensator.n_mc)] if mc else [])
        got = [tuple(t.shape) for t in noise]
        if got != want:
            raise ValueError(f"noise must be (dw, j{', mc_nodes' if mc else ''}"
                             f") of shapes {want}, got {got}")

    # ------------------------------------------------- hoisted collocation
    @profiling.spanned("fbsde.tables")
    def _hoist_tables(self, params, noise, shift_next: bool = False) -> dict:
        """Per-step tables {"lo", "hi", "cc"[, "pc"][, "zc"]} built outside
        the time loop from the first N rows of ``noise``.  The intervals
        come from the exact uncoupled X marginals of the drawn noise, padded
        in log space by ``hoist_pad_frac``; the coupling drift the intervals
        ignore is covered by the pad and the evaluators' boundary clamp.
        ``shift_next`` fits row i on the x_{i+1} marginal, where the
        sumlocal schemes evaluate their step-i heads; those schemes price
        the forward drift at X_i un-hoisted, so no price table is built
        then.  The Z table "zc" is the jump-diffusion global scheme's only.
        The compensator sweeps the quadrature, or each step's Monte-Carlo
        draws (through the rank-1 sweep under ``sweep_impl="pallas"``, one
        call per step, as in the JAX package)."""
        model, n = self.model, self.model.N
        dw, j = noise[0], noise[1]
        incr = model.uncoupled_log_increments(dw[:n], j[:n])
        csum = torch.cumsum(incr, dim=0)
        if not shift_next:                                          # x_i
            csum = torch.cat([torch.zeros_like(csum[:1]), csum[:-1]], dim=0)
        lx = math.log(model.x0) + csum
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
            comp = self._sweep_comp_at(params, steps[:, 0], nodes,
                                       noise[2][:n], None)
        else:
            comp = self._sweep_comp_at(params, steps[:, 0], nodes,
                                       *self._quad)
        out = {"lo": lo, "hi": hi, "cc": fit(comp)}
        if self._price_collocated() and not shift_next:
            out["pc"] = fit(model.price(steps, nodes))
        if self.hoist_z and self.scheme == "global" and self.jump_diff:
            out["zc"] = fit(self._uz(params, steps, nodes)[..., 0])
        if (self.hoist_gamma and self.hoist_interp == "piecewise"
                and self.use_gam_net):
            out.update(self._gamma_tables(params, j[:n], lo, hi))
        return out

    def _gamma_tables(self, params, j, lo, hi) -> dict:
        """{"gc", "jlo", "jhi"}: per step the 2-D table (pieces pairs ×
        coefficients) of the Γ head over [lo_i, hi_i] × the range of the
        step's drawn jumps, padded by 1% (and 1e-4, should a step draw no
        jump), from one batched evaluation of the head on every (step,
        x-node, j-node)."""
        jlo = j.min(dim=1).values.detach()
        jhi = j.max(dim=1).values.detach()
        jpad = 0.01 * (jhi - jlo) + 1e-4
        jlo, jhi = jlo - jpad, jhi + jpad
        px, dx = self.pw_pieces, self.pw_degree
        pj, dj = self.pw_pieces_j, self.pw_degree_j
        xn, jn = pw2_nodes(lo, hi, jlo, jhi, px, dx, pj, dj)
        steps = torch.arange(j.shape[0], device=lo.device)[:, None, None]
        vals = self._gamma_head(params, steps, xn[:, :, None],
                                jn[:, None, :])              # (N, nx, nj)
        return {"gc": pw2_fit(vals, px, dx, pj, dj), "jlo": jlo, "jhi": jhi}

    # ----------------------------------------------------- kernel conditions
    def _head_unmet(self, max_width: int) -> List[str]:
        """Why the Γ head does not fit a pair of CUDA kernels: they take
        two equal tanh hidden layers of a width in 1..``max_width``."""
        h = self.hidden
        reasons = []
        if self.activation != "tanh":
            reasons.append(f"activation {self.activation!r} != 'tanh'")
        if not (len(h) == 2 and h[0] == h[1] and 1 <= h[0] <= max_width):
            reasons.append(f"hidden {tuple(h)} must be two equal layers of a "
                           f"width in 1..{max_width}")
        return reasons

    def fused_unmet(self) -> List[str]:
        """The unmet preconditions of the fused rollout kernels (empty when
        they apply): the global scheme on the hoisted piecewise path, a
        Merton-form model, a head the kernels take, and degree-7 tables."""
        reasons = []
        if self.scheme != "global":
            reasons.append(f"scheme {self.scheme!r}: the kernels run the "
                           "global scheme's rollout")
        if not self.hoist or self.hoist_interp != "piecewise":
            reasons.append("needs hoist=True and hoist_interp='piecewise'")
        reasons += self._head_unmet(ROLLOUT_MAX_WIDTH)
        if self.pw_degree + 1 != KERNEL_COEFFS:
            reasons.append(f"pw_degree {self.pw_degree} != "
                           f"{KERNEL_COEFFS - 1}")
        if merton_form_constants(self.model) is None:
            reasons.append("the model is not of Merton form "
                           "(merton_form_constants)")
        if not self.hoist_z:
            reasons.append("needs hoist_z=True (the kernels read a Z table)")
        if self.hoist_gamma:
            reasons.append("hoist_gamma: the kernels evaluate the Γ head")
        if not self._price_collocated():
            reasons.append("needs a collocated price (the kernels read a "
                           "price table)")
        if self._cdtype is not None:
            reasons.append(f"compute_dtype {self.compute_dtype!r}: the "
                           "kernels compute in f32")
        return reasons

    def adjoint_unmet(self) -> List[str]:
        """The unmet preconditions of the hand-written adjoint (empty when
        it applies), the JAX package's ``_adjoint_ok``: the global
        jump-diffusion scheme on the hoisted piecewise path with the Z and
        price tables."""
        reasons = []
        if self.scheme != "global" or not self.jump_diff:
            reasons.append(f"scheme {self.scheme!r} in the "
                           f"{self.model.regime} regime: the adjoint runs "
                           "the global jump-diffusion rollout")
        if not self.hoist or self.hoist_interp != "piecewise":
            reasons.append("needs hoist=True and hoist_interp='piecewise'")
        if not self.hoist_z:
            reasons.append("needs hoist_z=True")
        if not self._price_collocated():
            reasons.append("needs a collocated price")
        return reasons

    def sweep_unmet(self) -> List[str]:
        """The unmet preconditions of the sweep kernels B3/B4 (empty when
        they apply): a swept head the kernels take (two equal tanh layers at
        most ``SWEEP_MAX_WIDTH`` wide and one output: a Γ net, or the
        pure-jump U-net of multistep1/sumlocal1, not the jump-diffusion
        2-output U-net) and f32 heads; under ``comp_axis`` they sweep the
        rank's slice of the nodes.  The JAX package warns and falls back to
        its XLA sweep on these; the port refuses them (the pricing pipeline
        chooses the plain sweep for such a method before it builds the
        solver, and says so)."""
        reasons = self._head_unmet(SWEEP_MAX_WIDTH)
        if not self.use_gam_net and self.with_heads and self.jump_diff:
            reasons.append(f"scheme {self.scheme!r} sweeps the 2-output "
                           "U-net, Γ = U(t, X·e^J)[0]; the kernels take a "
                           "Γ net of one output")
        if self._cdtype is not None:
            reasons.append(f"compute_dtype {self.compute_dtype!r}: the "
                           "kernels compute in f32")
        return reasons

    # --------------------------------------------------------------- global
    def _rollout(self) -> Optional[Callable]:
        """The hoisted global rollout of the fused kernels or of the
        hand-written adjoint, ``roll(gam_params, y0, tables, dw, j) ->
        (x_N, y_N)``; None for the solver's own loop."""
        if self.fused_rollout:
            return FusedRolloutOp(self.model, self.hidden[0],
                                  time_scale=self.time_scale,
                                  n_pieces=self.pw_pieces,
                                  degree=self.pw_degree,
                                  head_precision=self.fused_head_precision)
        if self._adjoint:
            from deepfbsdejsolvers_torch.solvers.adjoint import (
                make_global_adjoint_rollout)

            return make_global_adjoint_rollout(
                self.model, lambda gp, i, x, j: self._apply(
                    gp, self._gamma_inputs(i, x, j))[..., 0])
        return None

    def _mc_rows(self, noise):
        """The per-step Monte-Carlo node draws of ``noise``, or a row of
        Nones without the Monte-Carlo compensator."""
        if self.compensator.kind == "mc":
            return noise[2]
        return [None] * noise[1].shape[0]

    def _fstep(self, i, x, dw, j, y, price=None):
        """The model's forward step; the pure-jump step takes no dW."""
        if self.jump_diff:
            return self.model.step(i, x, dw, j, y, price=price)
        return self.model.step(i, x, j, y, price=price)

    def _rollout_direct(self, params, noise, trace: bool = False):
        """(x_N, y_N) of the un-hoisted global rollout: each step's heads,
        compensator sweep and pricer evaluated in the step.  With ``trace``
        the (N + 1, B) trajectories of X and Y instead."""
        model, dt = self.model, self.model.dt
        dw, j, mc = noise[0], noise[1], self._mc_rows(noise)
        x = model.init_x(j.shape[1], j.device)
        y = params[self._y0_head]["y0"] * torch.ones_like(x)

        def body(carry, i):
            x, y = carry
            gam, comp = self._gamma_and_compensator(params, i, x, j[i], mc[i])
            y = y - dt * model.f(y) + gam - comp
            if self.jump_diff:
                y = y + self._uz(params, i, x)[..., 0] * dw[i]
            x = self._fstep(i, x, dw[i], j[i], y)
            return (x, y), ((x, y) if trace else None)

        (x_n, y_n), path = self._scan(body, (x, y), model.N)
        if trace:
            return (torch.cat([x[None], path[0]]),
                    torch.cat([y[None], path[1]]))
        return x_n, y_n

    def _global_hoisted(self, params, tables, noise):
        """(x_N, y_N) of the hoisted global rollout read from ``tables``:
        ``rollout_plain``'s loop with the solver's Γ (the head, or its 2-D
        table), price (its table, or the model's pricer where there is
        none), Z (its table, or the Z head) and chunked time loop."""
        return rollout_plain(
            self.model, None, params[self._y0_head]["y0"], tables, noise[0],
            noise[1], x_prop=self._x_prop,
            gamma=lambda i, x, ji: self._table_gamma(params, tables, i, x,
                                                     ji),
            price=lambda i, x: self._step_price(tables, i, x),
            z=lambda i, x: self._step_z(params, tables, i, x),
            scan=self._scan)

    def _global_loss(self, params, noise, roll):
        if not self.hoist:
            x_n, y_n = self._rollout_direct(params, noise)
        elif roll is None:
            x_n, y_n = self._global_hoisted(
                params, self._hoist_tables(params, noise), noise)
        else:
            # the kernels' tables at the head's precision
            with tf32_allowed(self.fused_rollout and head_tf32_of(
                    self.fused_head_precision)):
                tables = self._hoist_tables(params, noise)
            x_n, y_n = roll(params["gam"], params[self._y0_head]["y0"],
                            tables, noise[0], noise[1])
        return torch.mean(torch.square(y_n - self.model.payoff(x_n)))

    # ------------------------------------------------------------- multistep
    def _multistep_loss(self, params, noise):
        """multistep1/2 and multistep_reg: the forward-replication loss
        mean_i E(Y_i + Σ_{j≥i} toAdd_j − g(X_N))², toAdd_i = −f(Y_i)·dt
        [+ Γ_i − comp_i + Z_i·dW_i]."""
        model, dt = self.model, self.model.dt
        dw, j, mc = noise[0], noise[1], self._mc_rows(noise)
        heads = self.with_heads
        tables = (self._hoist_tables(params, noise)
                  if heads and self.hoist else None)
        x = model.init_x(j.shape[1], j.device)

        def body(x, i):
            out = self._uz(params, i, x)
            y = out[..., 0]
            to_add = -dt * model.f(y)
            if heads:
                gam, comp = self._heads_gamma_comp(params, tables, i, x, j[i],
                                                   mc[i])
                to_add = to_add + gam - comp
                if self.jump_diff:
                    to_add = to_add + out[..., 1] * dw[i]
            x = self._fstep(i, x, dw[i], j[i], y,
                            price=self._step_price(tables, i, x))
            return x, (y, to_add)

        x, (ys, adds) = self._scan(body, x, model.N)
        fwd = ys + _suffix_sum(adds)                               # (N, B)
        # a mean over steps, as the reference's reduce_sum wraps an
        # already-scalar double mean
        return torch.mean(torch.square(fwd - model.payoff(x)[None, :]))

    # -------------------------------------------------------------- sumlocal
    def _sumlocal_heads(self, params, tables, i, x, j, mc_nodes):
        """(Y, Z, Γ, compensator) of the sumlocal schemes at (i, x, j); Z, Γ
        and the compensator are None for the regression, Z also in the
        pure-jump regime."""
        out = self._uz(params, i, x)
        if not self.with_heads:
            return out[..., 0], None, None, None
        gam, comp = self._heads_gamma_comp(params, tables, i, x, j, mc_nodes)
        z = out[..., 1] if self.jump_diff else None
        return out[..., 0], z, gam, comp

    def _sumlocal_loss(self, params, noise):
        """sumlocal1/2 and sumlocal_reg: the one-step residual loss
        Σ_i E(Y_{i+1} − Y_i + toAdd_i)², toAdd_i = f(Y_i)·dt
        [− Γ_i + comp_i − Z_i·dW_i], on N + 1 rows of noise.

        Row N feeds the heads at (t = 0, X_0) before the loop, un-hoisted;
        its dW is never read.  Step i moves X with the jump carried from the
        row before (row N at i = 0), then evaluates the heads at X_{i+1}
        with time feature i and the jump of row i, which the next step
        carries.  The heads of the last step are evaluated and unused: Y_N
        is the payoff."""
        model, n, dt = self.model, self.model.N, self.model.dt
        dw, j_all, mc = noise[0], noise[1], self._mc_rows(noise)
        heads = self.with_heads
        x = model.init_x(j_all.shape[1], j_all.device)
        j = j_all[n]
        y_prev, z_prev, gam_prev, comp_prev = self._sumlocal_heads(
            params, None, 0, x, j, mc[n])
        tables = (self._hoist_tables(params, noise, shift_next=True)
                  if heads and self.hoist else None)

        def body(carry, i):
            x, j, y_prev, z_prev, gam_prev, comp_prev = carry
            to_add = dt * model.f(y_prev)
            if heads:
                to_add = to_add - gam_prev + comp_prev
                if self.jump_diff:
                    to_add = to_add - z_prev * dw[i]
            # the forward drift's A(i, X_i) is priced un-hoisted: the
            # shift_next tables span the x_{i+1} marginals
            x = self._fstep(i, x, dw[i], j, y_prev)
            y_net, z_prev, gam_prev, comp_prev = self._sumlocal_heads(
                params, tables, i, x, j_all[i], mc[i])
            y_next = model.payoff(x) if i == n - 1 else y_net
            err = torch.mean(torch.square(y_next - y_prev + to_add))
            return (x, j_all[i], y_next, z_prev, gam_prev, comp_prev), err

        carry = (x, j, y_prev, z_prev, gam_prev, comp_prev)
        return torch.sum(self._scan(body, carry, n)[1])

    # ------------------------------------------------------------------ loss
    def build_loss_from_noise(self, batch: int, mesh=None) -> Callable:
        """``loss(params, noise)`` on given noise tensors — (dw, j), or (dw,
        j, mc_nodes) with the Monte-Carlo compensator, each of
        ``noise_rows`` rows, dw (rows, 0) in the pure-jump regime — so that
        the same noise can drive this solver and another implementation.
        With ``comp_axis``, the loss of this rank of ``mesh``."""
        s = self._on_mesh(mesh)
        roll = (s._rollout() if s.hoist and s.scheme == "global" else None)

        def loss(params, noise):
            s._check_noise(noise, batch)
            if s.scheme == "global":
                return s._global_loss(params, noise, roll)
            if s.scheme.startswith("multistep"):
                return s._multistep_loss(params, noise)
            return s._sumlocal_loss(params, noise)

        return loss

    def build_loss(self, batch: int, mesh=None) -> Callable:
        """``loss(params, generator)``: draws the noise on ``generator``
        (which must live on ``self.device``), then the loss above."""
        from_noise = self.build_loss_from_noise(batch, mesh)

        def loss(params, generator):
            with profiling.span("fbsde.noise"):
                noise = self._prenoise(generator, batch, self.noise_rows)
            return from_noise(params, noise)

        return loss

    # ------------------------------------------------------------- evaluation
    def y0_estimate(self, params: Params) -> torch.Tensor:
        """Current Y0: the trainable scalar of the global scheme (on the Γ
        net in the pure-jump regime), else the U-net's U(0, x0) (the
        reference's mean over identical inputs X_0 = x0 equals the single
        evaluation)."""
        if self.scheme == "global":
            return params[self._y0_head]["y0"]
        x = self.model.init_x(1, params["uz"]["W"][0].device)
        return self._uz(params, 0, x)[0, 0]

    def warm_start_y0(self, params: Params, generator: torch.Generator,
                      batch: int = 65536) -> Params:
        """Params with the trainable scalar y0 set to the discounted-payoff
        Monte-Carlo estimate e^{-rT} E[g(X_N)] under the uncoupled dynamics
        (coupling zeroed, Y fed as 0), drawn on ``generator``: an
        oracle-free start that keeps Adam out of the spurious negative-Y0
        basin a unit-normal draw of y0 can land in.  Only the global scheme
        has a y0 (on the Γ net in the pure-jump regime)."""
        head = self._y0_head
        if "y0" not in params.get(head, {}):
            raise ValueError(
                f"scheme {self.scheme!r} has no trainable y0 to warm-start")
        from deepfbsdejsolvers_torch.models.merton import abs_coupling

        model = dataclasses.replace(self.model, coupling=abs_coupling(0.0))
        dev = generator.device
        with torch.no_grad():
            x = model.init_x(batch, dev)
            zero = torch.zeros_like(x)
            for i in range(model.N):
                dw = (math.sqrt(model.dt) * torch.randn(
                    (batch,), generator=generator, device=dev)
                      if self.jump_diff else None)
                j = model.sample_jumps(generator, (batch,))
                noise = (dw, j) if self.jump_diff else (j,)
                # the coupling 0·|Y − A| drops A, so no path is priced
                x = model.step(i, x, *noise, zero, price=zero)
            y0 = math.exp(-model.r * model.T) * torch.mean(model.payoff(x))
        old = params[head]["y0"]
        out = dict(params)
        out[head] = dict(params[head], y0=y0.to(old.device, old.dtype))
        return out

    def hoist_clamp_fractions(self, params: Params,
                              generator: torch.Generator,
                              batch: int = 8192) -> torch.Tensor:
        """Per-step fraction (N,) of coupled paths outside the hoisted
        intervals [lo_i, hi_i], on a fresh draw of the loss's noise: the
        check of the ``hoist_pad_frac`` policy (see
        ``clamp_fractions_from_noise``)."""
        return self.clamp_fractions_from_noise(
            params, self._prenoise(generator, batch, self.noise_rows))

    def clamp_fractions_from_noise(self, params: Params,
                                   noise) -> torch.Tensor:
        """The clamp fractions on given noise.  The intervals come from the
        uncoupled X marginals; a coupled path outside its step's interval
        clamps to the boundary in the table evaluators.  This rolls the
        coupled forward as the scheme's loss does (global: the BSDE-carried
        Y through the hoisted heads; multistep: the head's Y; sumlocal: the
        head's Y, counting the step-(i+1) state against the shift_next
        tables)."""
        if not self.hoist:
            raise ValueError("hoist_clamp_fractions needs hoist=True")
        model, n, dt = self.model, self.model.N, self.model.dt
        dw, j_all = noise[0], noise[1]
        sumlocal = self.scheme.startswith("sumlocal")
        with torch.no_grad():
            tables = self._hoist_tables(params, noise, shift_next=sumlocal)
            out_frac = lambda i, x: torch.mean(
                ((x < tables["lo"][i]) | (x > tables["hi"][i])).to(x.dtype))
            x = model.init_x(j_all.shape[1], j_all.device)
            fracs = []
            if sumlocal:
                j, y = j_all[n], self._uz(params, 0, x)[..., 0]
                for i in range(n):
                    x = self._fstep(i, x, dw[i], j, y)
                    fracs.append(out_frac(i, x))
                    y = (model.payoff(x) if i == n - 1
                         else self._uz(params, i, x)[..., 0])
                    j = j_all[i]
                return torch.stack(fracs)
            y = (params[self._y0_head]["y0"] if self.scheme == "global"
                 else torch.zeros(())) * torch.ones_like(x)
            for i in range(n):
                fracs.append(out_frac(i, x))
                if self.scheme == "global":
                    gam, comp = self._heads_gamma_comp(params, tables, i, x,
                                                       j_all[i], None)
                    y = y - dt * model.f(y) + gam - comp
                    if self.jump_diff:
                        y = y + self._step_z(params, tables, i, x) * dw[i]
                else:
                    y = self._uz(params, i, x)[..., 0]
                x = self._fstep(i, x, dw[i], j_all[i], y,
                                price=self._step_price(tables, i, x))
            return torch.stack(fracs)

    def simulate_paths(self, params: Params, generator: torch.Generator,
                       batch: int):
        """(X, Y) trajectories (N + 1, B) of the global scheme under the
        trained policy, un-hoisted, on a fresh draw of noise."""
        if self.scheme != "global":
            raise ValueError("simulate_paths needs the global scheme (an "
                             "explicit Y)")
        with torch.no_grad():
            return self._rollout_direct(
                params, self._prenoise(generator, batch), trace=True)
