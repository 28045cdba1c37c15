"""The reference's training steps of the global deep-BSDE scheme.

``Scheme`` holds a configuration's model and the cell's numerical method:
the compensator's jump quadrature or its Monte-Carlo draws, and either the
per-step evaluation (``hoist=False``: at each step Γ at the realized jump,
the compensator by sweeping Γ over the quadrature, or over the step's own
``n_mc`` fresh draws of the jump law, at every path, the price by the
model's pricer) or the hoisted tables (``hoist=True``, quadrature only: per
step piecewise Chebyshev fits of the compensator, the price and the Z head
on the uncoupled spot interval, read by each path).  ``loss_and_grads``
runs a step's loss and gradients in blocks of paths, and a Monte-Carlo
compensator in blocks of draws too, so that it fits beside the program's
footprint; the hoisted tables are built once from all paths and their
cotangents summed over the blocks.  ``follow`` runs Adam's first steps from
the same weights and generator state as the program, each step's noise
(dW, J, then the draws) redrawn as the program draws it.

Parameters are a dict of heads, each {"W": [...], "b": [...], ("y0")},
weights laid out (in, out): "uz" the Z net on (t, X) carrying Y0 in the
jump-diffusion regime; "gam" the Γ net on (t, X, f) with f = J
(jump-diffusion) or X·J (pure jump, where it carries Y0).
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from benchmark.reference.models import MODELS

# Path-draw pairs a block of the Monte-Carlo compensator evaluates at once
# (a block's hidden activation, rows × 21 floats, ~1.4 GB).
NODE_ROWS = 1 << 24


@contextlib.contextmanager
def full_f32():
    """FP32 matmuls with TF32 off on the card; restored on exit."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 mantissa bits, to nearest, ties away from 0):
    what the tensor cores read of an FP32 operand."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


class _Linear(torch.autograd.Function):
    """x @ w (+ b) over rows x (..., K), w (K, M): in FP32, or with
    ``tf32`` each product's operands rounded to TF32 as one TF32 pass of
    the tensor cores reads them.  The weight's and the bias's cotangents,
    sums over every row (millions of path-nodes), are summed in float64:
    the Γ head's gradient is the difference of two such sums that cancel
    to a few percent, which FP32 sums of that length would not keep."""

    @staticmethod
    def forward(ctx, x, w, b, tf32_products):
        xr, wr = (tf32(x), tf32(w)) if tf32_products else (x, w)
        ctx.save_for_backward(xr, wr)
        ctx.tf32, ctx.has_b = tf32_products, b is not None
        y = torch.matmul(xr, wr)
        return y + b if b is not None else y

    @staticmethod
    def backward(ctx, g):
        xr, wr = ctx.saved_tensors
        gr = tf32(g) if ctx.tf32 else g
        gx = torch.matmul(gr, wr.transpose(0, 1))
        rows_x = xr.reshape(-1, xr.shape[-1]).double()
        rows_g = gr.reshape(-1, gr.shape[-1]).double()
        gw = (rows_x.transpose(0, 1) @ rows_g).to(wr.dtype)
        gb = (g.reshape(-1, g.shape[-1]).double().sum(0).to(wr.dtype)
              if ctx.has_b else None)
        return gx, gw, gb, None


def matmul(a: torch.Tensor, w: torch.Tensor, b=None,
           tf32_products: bool = False) -> torch.Tensor:
    """a (..., K) @ w (K, M) (+ b): ``_Linear``."""
    return _Linear.apply(a, w, b, tf32_products)


def mlp(head: dict, x: torch.Tensor, tf32_products: bool = False
        ) -> torch.Tensor:
    """tanh MLP: x (..., n_in) → (..., n_out)."""
    n = len(head["W"])
    for k, (w, b) in enumerate(zip(head["W"], head["b"])):
        x = matmul(x, w, b, tf32_products)
        if k < n - 1:
            x = torch.tanh(x)
    return x


def net_layout(cfg: dict, jump_diffusion: bool) -> Dict[str, tuple]:
    """{head: (n_in, hidden, n_out, carries_y0)} of the global scheme."""
    h = tuple(int(v) for v in cfg["hidden"])
    if jump_diffusion:
        return {"gam": (3, h, 1, False), "uz": (2, h, 1, True)}
    return {"gam": (3, h, 1, True)}


def leaves(params: dict) -> List[tuple]:
    """[(name, tensor)] in a fixed order: heads by name, then W, b, y0."""
    out = []
    for head in sorted(params):
        p = params[head]
        for k in sorted(p):
            if k == "y0":
                out.append((f"{head}.y0", p[k]))
            else:
                out += [(f"{head}.{k}{i}", t) for i, t in enumerate(p[k])]
    return out


def _pw_points(pieces: int, degree: int) -> np.ndarray:
    d = degree + 1
    t_loc = -np.cos(np.pi * (np.arange(d) + 0.5) / d)
    return ((np.arange(pieces)[:, None] + 0.5 * (t_loc[None, :] + 1.0))
            / pieces).reshape(-1).astype(np.float32)


def _pw_fit_matrix(degree: int) -> np.ndarray:
    d = degree + 1
    t_loc = -np.cos(np.pi * (np.arange(d) + 0.5) / d)
    cheb = np.cos(np.arange(d)[None, :] * np.arccos(t_loc[:, None]))
    return np.linalg.inv(cheb).astype(np.float32)


def _check_supported(cfg: dict, model_opts: dict, solver: dict) -> None:
    """Refuse a cell whose method this reference does not compute, rather
    than compare it with another method: the global scheme, FP32 heads,
    the compensator over a quadrature, at every path per step or through
    hoisted piecewise tables, or over each step's Monte-Carlo draws at
    every path per step; a step's price by the series (Merton) or the FFT
    curve read at every path (VG)."""
    hoist = bool(solver.get("hoist", False))
    unmet = []
    if solver.get("scheme") != "global":
        unmet.append(f"scheme {solver.get('scheme')!r}")
    if cfg.get("activation") != "tanh":
        unmet.append(f"activation {cfg.get('activation')!r}")
    comp = solver.get("compensator", {})
    kind = comp.get("kind", "quadrature")
    if kind not in ("quadrature", "mc") or (kind == "mc" and hoist):
        unmet.append(f"compensator kind {kind!r}"
                     + (" with hoisted tables" if hoist else ""))
    if hoist and solver.get("hoist_interp") != "piecewise":
        unmet.append("hoisted tables other than piecewise")
    if not hoist and comp.get("x_interp", "direct") != "direct":
        unmet.append("a per-step compensator other than at every path")
    if hoist and (solver.get("hoist_gamma") or
                  solver.get("hoist_z") is False):
        unmet.append("hoist_gamma or hoist_z=False")
    if solver.get("compute_dtype") not in (None, "float32"):
        unmet.append(f"compute_dtype {solver.get('compute_dtype')!r}")
    if solver.get("fused_head_precision") not in (None, "highest"):
        unmet.append("a TF32 head")
    if cfg["model"] == "merton" and not hoist and model_opts.get(
            "price_mode", "series") != "series":
        unmet.append(f"price_mode {model_opts.get('price_mode')!r}")
    if cfg["model"] == "variance_gamma" and (
            model_opts.get("pricer", "fft") != "fft"
            or model_opts.get("price_eval", "direct") != "direct"):
        unmet.append("a VG price other than the FFT curve at every path")
    if unmet:
        raise ValueError("the reference does not compute: "
                         + "; ".join(unmet))


class Scheme:
    """One cell's training step, planned from the configuration (``cfg``)
    and the cell's solver settings (``solver``: the program's keyword
    names, read here as data).  ``block`` paths at a time; a Monte-Carlo
    compensator ``NODE_ROWS // block`` draws at a time within them."""

    def __init__(self, cfg: dict, model_opts: dict, solver: dict, batch: int,
                 device, block: int = 1 << 16, tf32_products: bool = False):
        _check_supported(cfg, model_opts, solver)
        kind = MODELS[cfg["model"]]
        self.model = kind(cfg, device,
                          jump_sampler=model_opts.get("jump_sampler",
                                                      "exact"))
        self.cfg, self.batch, self.device = cfg, batch, device
        self.block = min(block, batch)
        self.tf32 = tf32_products
        self.hoist = bool(solver.get("hoist", False))
        comp = solver["compensator"]
        self.n_mc = (int(comp["n_mc"]) if comp.get("kind") == "mc"
                     else None)
        if self.n_mc:
            self.nodes = self.weights = None
            self.node_block = max(1, NODE_ROWS // self.block)
        elif self.model.jump_diffusion:
            self.nodes, self.weights = self.model.quadrature(
                comp["n_poisson_max"], comp["n_hermite"], device)
        else:
            self.nodes, self.weights = self.model.quadrature(
                comp["n_laguerre"], comp["n_hermite"], device)
        if self.hoist:
            self.pieces = int(solver["pw_pieces"])
            self.degree = int(solver["pw_degree"])
            self.pad = float(solver["hoist_pad_frac"])
            self.points = torch.as_tensor(
                _pw_points(self.pieces, self.degree), device=device)
            self.fit = torch.as_tensor(_pw_fit_matrix(self.degree),
                                       device=device)

    @property
    def n_nodes(self) -> int:
        return self.n_mc or int(self.nodes.shape[0])

    def draw(self, g: torch.Generator):
        """One step's noise from ``g``, in the training step's order: (dW,
        J), then with a Monte-Carlo compensator the (N, n_mc) jump draws of
        every time step by the same sampler."""
        dw, j = self.model.draw(g, self.batch)
        if not self.n_mc:
            return dw, j
        return dw, j, self.model.jumps(g, (self.model.N, self.n_mc))

    # ---- heads ------------------------------------------------------------
    def _feature(self, x, j):
        return x * j if not self.model.jump_diffusion else j

    def gamma(self, params, i, x, j):
        """Γ(t = i, x, f(x, J)) broadcast over (i, x, j)."""
        t = torch.as_tensor(float(i) if isinstance(i, int) else i,
                            dtype=x.dtype, device=x.device)
        t, xb, jb = torch.broadcast_tensors(t, x, j)
        cols = torch.stack([t, xb, self._feature(xb, jb)], -1)
        return mlp(params["gam"], cols, self.tf32)[..., 0]

    def z(self, params, i, x):
        t = torch.broadcast_to(torch.as_tensor(
            float(i) if isinstance(i, int) else i, dtype=x.dtype,
            device=x.device), x.shape)
        return mlp(params["uz"], torch.stack([t, x], -1), self.tf32)[..., 0]

    def y0(self, params):
        return params["uz" if self.model.jump_diffusion else "gam"]["y0"]

    def compensator(self, params, i, x):
        """Σ_m w_m·Γ(i, x, J_m) at every x."""
        sweep = self.gamma(params, i, x[None, :], self.nodes[:, None])
        return (self.weights[:, None] * sweep).sum(0)

    def _draws_sum(self, params, i, x, draws):
        """Σ_m Γ(i, x, J_m) over ``draws`` at every x, summed in float64."""
        sweep = self.gamma(params, i, x[None, :], draws[:, None])
        return sweep.sum(0, dtype=torch.float64)

    def mc_compensator(self, params, i, x, draws):
        """(1/M)·Σ_m Γ(i, x, J_m) at every x over the step's M draws, the
        plain mean, ``node_block`` draws at a time, each block under
        checkpoint: until the backward only its inputs and its (B,) sum
        persist, and the backward replays one block at a time."""
        total = None
        for s in range(0, draws.shape[0], self.node_block):
            part = checkpoint(self._draws_sum, params, i, x,
                              draws[s:s + self.node_block],
                              use_reentrant=False)
            total = part if total is None else total + part
        return (total / draws.shape[0]).to(x.dtype)

    # ---- hoisted tables -----------------------------------------------------
    def tables(self, params, dw, j):
        """{"lo", "hi", "cc", "pc", "zc"} from all paths' noise: per step the
        uncoupled spot range padded in log space, and the compensator, the
        price and Z fitted on it as P pieces of degree D."""
        m, n = self.model, self.model.N
        lx = torch.cumsum(m.log_increments(dw, j), 0)
        lx = math.log(m.x0) + torch.cat([torch.zeros_like(lx[:1]),
                                         lx[:-1]])
        llo, lhi = lx.min(1).values, lx.max(1).values
        lpad = self.pad * (lhi - llo) + 0.01
        lo, hi = torch.exp(llo - lpad), torch.exp(lhi + lpad)
        x = lo[:, None] + (hi - lo)[:, None] * self.points          # (N, C)
        steps = torch.arange(n, device=x.device)
        ts = steps.to(torch.float32)[:, None, None]
        sweep = self.gamma(params, ts, x[:, None, :],
                           self.nodes[None, :, None])            # (N, M, C)
        comp = (self.weights[None, :, None] * sweep).sum(1)
        fit = lambda v: matmul(v.reshape(n, self.pieces, self.degree + 1),
                               self.fit.T, None, self.tf32)
        out = {"lo": lo, "hi": hi, "cc": fit(comp),
               "pc": fit(m.price(steps[:, None], x))}
        if m.jump_diffusion:
            out["zc"] = fit(self.z(params, steps.to(torch.float32)[:, None],
                                   x))
        return out

    def table_eval(self, coef, x, lo, hi):
        """One step's piecewise table at x, clamped to [lo, hi]: the piece's
        row by a one-hot product, then Σ_k c_k·T_k(t)."""
        p = coef.shape[0]
        s = torch.clamp((x - lo) / torch.clamp(hi - lo, min=1e-6), 0.0,
                        1.0) * p
        k = torch.clamp(torch.floor(s), 0, p - 1).detach()
        t = 2.0 * (s - k) - 1.0
        onehot = (k.long()[:, None] == torch.arange(p, device=x.device)
                  ).to(x.dtype)
        rows = matmul(onehot, coef, None, self.tf32)
        basis = [torch.ones_like(t), t]
        for _ in range(2, coef.shape[1]):
            basis.append(2.0 * t * basis[-1] - basis[-2])
        return (torch.stack(basis, -1) * rows).sum(-1)

    # ---- one block of paths -------------------------------------------------
    def _block_sse(self, params, tables, dw, j, draws=None):
        """Σ_b (Y_N − (X_N − K)⁺)² over one block's paths; ``draws`` the
        (N, n_mc) Monte-Carlo draws, or None over the quadrature."""
        m = self.model
        x = torch.full((j.shape[1],), m.x0, device=j.device)
        y = self.y0(params) * torch.ones_like(x)
        for i in range(m.N):
            gam = self.gamma(params, i, x, j[i])
            if tables is None:
                comp = (self.mc_compensator(params, i, x, draws[i])
                        if draws is not None else
                        checkpoint(self.compensator, params, i, x,
                                   use_reentrant=False))
                a = m.price(i, x)
                zi = self.z(params, i, x) if m.jump_diffusion else None
            else:
                lo, hi = tables["lo"][i], tables["hi"][i]
                comp = self.table_eval(tables["cc"][i], x, lo, hi)
                a = self.table_eval(tables["pc"][i], x, lo, hi)
                zi = (self.table_eval(tables["zc"][i], x, lo, hi)
                      if m.jump_diffusion else None)
            y = y - m.dt * (-m.r * y) + gam - comp
            if zi is not None:
                y = y + zi * dw[i]
            x = m.step(x, dw[i] if m.jump_diffusion else None, j[i], y, a)
        return torch.sum(torch.square(y - torch.clamp(x - m.K, min=0.0)))

    def loss_and_grads(self, params, dw, j, draws=None):
        """(loss, {leaf name: gradient}) of one training step on (dW, J)
        (and the Monte-Carlo ``draws``), in blocks of paths; the loss summed
        in float64."""
        named = leaves(params)
        tensors = [t for _, t in named]
        total = torch.zeros((), dtype=torch.float64, device=j.device)
        grads = [torch.zeros_like(t, dtype=torch.float64) for t in tensors]
        tables = tab_leaves = None
        tab_cot: Dict[str, torch.Tensor] = {}
        if self.hoist:
            tables = self.tables(params, dw, j)
            tab_leaves = {k: v.detach().requires_grad_(k in ("cc", "zc"))
                          for k, v in tables.items()}
        batch = j.shape[1]
        for s in range(0, batch, self.block):
            cols = slice(s, min(s + self.block, batch))
            sse = self._block_sse(
                params, tab_leaves, dw[:, cols] if dw.shape[1] else dw,
                j[:, cols], draws) / batch
            wrt = tensors + ([tab_leaves["cc"], tab_leaves["zc"]]
                             if self.hoist and "zc" in tab_leaves else
                             [tab_leaves["cc"]] if self.hoist else [])
            got = torch.autograd.grad(sse, wrt, allow_unused=True)
            for k, g in enumerate(got[:len(tensors)]):
                if g is not None:
                    grads[k] += g.double()
            if self.hoist:
                for name, g in zip(("cc", "zc"), got[len(tensors):]):
                    tab_cot[name] = tab_cot.get(name, 0.0) + g.double()
            total += sse.detach().double()
        if self.hoist:
            outs = [tables["cc"]] + ([tables["zc"]] if "zc" in tables else [])
            cots = [tab_cot["cc"].float()] + (
                [tab_cot["zc"].float()] if "zc" in tables else [])
            got = torch.autograd.grad(outs, tensors, cots, allow_unused=True)
            for k, g in enumerate(got):
                if g is not None:
                    grads[k] += g.double()
        return float(total), {name: g.to(t.dtype) for (name, t), g
                              in zip(named, grads)}


def adam_update(params, grads, state, lr, betas, eps):
    """One Adam update in place (PyTorch's and Keras' form: bias-corrected
    moments, eps added to the corrected root)."""
    b1, b2 = betas
    state["t"] = state.get("t", 0) + 1
    t = state["t"]
    for name, p in leaves(params):
        g = grads[name]
        m = state.setdefault(("m", name), torch.zeros_like(p))
        v = state.setdefault(("v", name), torch.zeros_like(p))
        m.mul_(b1).add_(g, alpha=1.0 - b1)
        v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
        denom = v.sqrt() / math.sqrt(1.0 - b2 ** t) + eps
        p.sub_(lr / (1.0 - b1 ** t) * m / denom)


def follow(scheme: Scheme, params0, gen_state, steps: int, cfg: dict):
    """The reference's first ``steps`` Adam steps from weights ``params0``
    (not modified) and a generator restored to ``gen_state``, each step
    drawing its noise as the training step does.  Returns (losses, the
    first step's gradients, the weights after the last step)."""
    dev = scheme.device
    params = {h: {k: ([t.detach().clone().requires_grad_(True) for t in v]
                      if isinstance(v, list)
                      else v.detach().clone().requires_grad_(True))
                  for k, v in p.items()} for h, p in params0.items()}
    g = torch.Generator(device=dev)
    g.set_state(gen_state)
    state: dict = {}
    losses, first = [], None
    with full_f32():
        for _ in range(steps):
            noise = scheme.draw(g)
            loss, grads = scheme.loss_and_grads(params, *noise)
            del noise
            losses.append(loss)
            if first is None:
                first = {k: v.clone() for k, v in grads.items()}
            with torch.no_grad():
                adam_update(params, grads, state, float(cfg["learning_rate"]),
                            tuple(cfg["adam_betas"]), float(cfg["adam_eps"]))
    return losses, first, {n: t.detach() for n, t in leaves(params)}


def norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.double()))


def upper_median(values) -> float:
    """The middle value, the upper of the two middle ones for an even
    count: always one of the values."""
    vals = sorted(values)
    return float(vals[len(vals) // 2])


def compare(prog_losses, prog_grads, prog_delta, ref_losses, ref_grads,
            ref_delta, skip_below: float = 1e-3) -> Dict[str, object]:
    """The numbers compared:

    ``loss_gap``   max over the steps of |L − L_ref| / |L_ref|;
    ``grad_gap``   max over leaves of |‖g‖ − ‖g_ref‖| / max(‖g_ref‖, the
                   median leaf's ‖g_ref‖), g the first step's gradient;
    ``update_gap`` the (upper) median over leaves of the same gap of the
                   weights' change over the steps, leaving out leaves whose
                   reference gradient is under ``skip_below`` of the
                   median leaf's (a gradient that is rounding alone, which
                   Adam scales up to a full step).  The median and not the
                   worst leaf: Adam divides each element by its own root
                   mean square, so an element whose gradient is near
                   rounding moves by a full step of either sign, and the
                   worst leaf's change swings from seed to seed
                   (``update_gap_worst``, with the leaves' names, is
                   returned beside it and not compared).  A step that
                   leaves its state unchanged reads 1 on both gaps."""
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(prog_losses,
                                                        ref_losses))
    names = list(ref_grads)
    gn = {n: norm(ref_grads[n]) for n in names}
    g_med = upper_median(gn.values())
    g_gaps = {n: abs(norm(prog_grads[n]) - gn[n]) / max(gn[n], g_med)
              for n in names}
    kept = [n for n in names if gn[n] >= skip_below * g_med]
    dn = {n: norm(ref_delta[n]) for n in kept}
    d_med = upper_median(dn.values())
    d_gaps = {n: abs(norm(prog_delta[n]) - dn[n]) / max(dn[n], d_med)
              for n in kept}
    worst_g = max(g_gaps, key=g_gaps.get)
    worst_d = max(d_gaps, key=d_gaps.get)
    return {"loss_gap": loss_gap, "grad_gap": g_gaps[worst_g],
            "update_gap": upper_median(d_gaps.values()),
            "update_gap_worst": d_gaps[worst_d],
            "grad_leaf": worst_g, "update_leaf": worst_d}
