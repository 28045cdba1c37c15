"""The hoisted global rollout: plain loop and fused CUDA kernels.

One training step of the hoisted global scheme runs, after the per-step
tables are built (solvers/pricing.py ``_hoist_tables``), the N-step rollout

    comp = cc_i(x);  Γ = MLP(i·time_scale, x, J)
    y ← y − f(y)·dt + Γ − comp + z_i(x)·dW
    x ← x·(1 + expm1_acc(drift + σ dW + J)) + aLin·|y − a_i(x)|·dt

where cc_i, pc_i (the price a_i) and zc_i are piecewise Chebyshev tables
(P pieces × D coefficients) on the step's interval [lo_i, hi_i].  In the
pure-jump regime (the Variance-Gamma model) the Γ net's input is
(t, x, x·J), and there is no Z·dW term, no Z table and no dW in the walk.

``rollout_plain`` is that loop written step by step in PyTorch and
differentiated by autograd, in either regime: the CPU path, the eager path
of the pure-jump model on the card, and the oracle the kernels are held
against.  The kernels take the Merton form only.  ``FusedRolloutOp`` is
the operator the solver calls: on a CPU tensor it runs ``rollout_plain``;
on a CUDA tensor it runs the whole forward as one kernel (B1) and, under
autograd, the whole backward as one kernel of a bounded number of blocks
plus a fixed-order reduction (B2), behind the ``FusedRollout`` autograd
function.  The kernels come in two builds: specialised at the hidden widths
``KERNEL_WIDTHS`` (8 and 21; ``csrc/rollout_fwd.cu``,
``csrc/rollout_bwd.cu``), and wide at every other width up to
``ROLLOUT_MAX_WIDTH`` (``csrc/rollout_wide_fwd.cu``,
``csrc/rollout_wide_bwd.cu``, zero-padded to a width class of 32, 64 or
128), each with its own launch count; ``rollout_kernels`` picks the pair of
a width.  There is no fallback from the kernels to the plain loop on the
card.

Each kernel has two instances, chosen by ``head_precision``: "highest"
(the default), the Γ head in f32 throughout; and "default", what the JAX
package's DEFAULT precision of an f32 dot is on this card, one TF32 pass:
every operand of the head's H×H products (h1·W2 forward and recomputed,
dp2·W2ᵀ and h1ᵀ·dp2 backward) rounded to TF32, the sums in f32 (the wide
B2's "default" instance runs its products in one TF32 pass on the tensor
cores).  The plain version applies the same rounding
(``ops/numerics.tf32_matmul``).  Each
wrapper counts its launches in ``launches`` and those of the "default"
instance also in ``launches_tf32``.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from deepfbsdejsolvers_torch.nets.mlp import mlp_apply
from deepfbsdejsolvers_torch.ops.chebyshev import cheb_eval
from deepfbsdejsolvers_torch.ops.numerics import tf32_matmul
from deepfbsdejsolvers_torch.ops.piecewise import pw_eval
from deepfbsdejsolvers_torch.ops.scan import chunked_scan

# Hidden widths the kernels are instantiated for (csrc/rollout_common.cuh).
KERNEL_WIDTHS = (8, 21)
# Chebyshev coefficients per piece the kernels take (degree 7).
KERNEL_COEFFS = 8
# Paths per tile of B2 (a block of 128 threads, one path each), and the
# most blocks it launches: four resident blocks on each of the H100's 132
# SMs.  Together they fix the order of B2's sums and bound its partial
# buffer (csrc/rollout_bwd.cu).
_B2_TILE = 128
_B2_MAX_BLOCKS = 4 * 132
# The widest head the wide kernels take: the JAX package's Pallas rollout
# and sweep take two equal tanh layers up to 128 wide.  The width classes
# of the wide kernels of both (csrc/tc_split.cuh), the paths a block of the
# wide B2 carries at every class (eight warps of one m16 tile), and its
# resident blocks per SM of an H100 by class and instance, FP32 (split
# TF32) and head-TF32 (its shared memory and registers:
# csrc/rollout_wide_bwd.cu bwd_blocks_per_sm), which bound the blocks it
# launches.
ROLLOUT_MAX_WIDTH = 128
_WIDE_CLASSES = (32, 64, 128)
_WIDE_TILE = 128
# The most paths a block of the wide B1 takes (256 at HP 32), which bounds
# the paths its blocks index (csrc/rollout_wide_fwd.cu ``Lanes``).
_WIDE_B1_MAX_TILE = 256
_WIDE_B2_BLOCKS_PER_SM = {(32, False): 2, (64, False): 2, (128, False): 1,
                          (32, True): 3, (64, True): 2, (128, True): 1}
_SMS = 132
# The Γ head's precisions of the fused rollout: the JAX package's names.
HEAD_PRECISIONS = ("highest", "default")


def head_tf32_of(precision) -> bool:
    """Whether a precision name (None: "highest") asks for the head-TF32
    instance; raises ``ValueError`` for another name."""
    name = "highest" if precision is None else str(precision).lower()
    if name not in HEAD_PRECISIONS:
        raise ValueError(f"precision must be one of {HEAD_PRECISIONS} or "
                         f"None, got {precision!r}")
    return name == "default"


def gamma_head(gam_params, cols, activation=torch.tanh,
               head_tf32: bool = False):
    """The Γ head (3 → H → H → 1) on ``cols``: ``mlp_apply``, or with
    ``head_tf32`` its H×H layer as a TF32 product.  There the first layer
    is summed term by term, t·W1[t] + x·W1[x] + f·W1[f] + b1, each operation
    rounded as the kernels' ``first_sum_tf32`` rounds it: h1 enters the
    product rounded to TF32, where a last-bit difference of h1 would
    become one of 2^-11."""
    if not head_tf32:
        return mlp_apply(gam_params, cols, activation)
    (w1, w2, w3), (b1, b2, b3) = gam_params["W"], gam_params["b"]
    c = cols[..., None]
    h1 = activation(c[..., 0, :] * w1[0] + c[..., 1, :] * w1[1]
                    + c[..., 2, :] * w1[2] + b1)
    h2 = activation(tf32_matmul(h1, w2) + b2)
    return torch.matmul(h2, w3) + b3


def wide_class(h: int) -> int:
    """The width class HP the wide kernels pad hidden width ``h`` to."""
    for hp in _WIDE_CLASSES:
        if 1 <= h <= hp:
            return hp
    raise ValueError(f"the wide kernels take hidden widths 1.."
                     f"{_WIDE_CLASSES[-1]}, got {h}")


def wide_tile(h: int) -> int:
    """Paths per block of the wide B2 at hidden width ``h``: eight warps of
    one m16 tile of 16 paths each, at every width class (the wide B1's
    blocks take 32·32·8 / HP paths, 256, 128 or 64, in both instances,
    csrc/rollout_wide_fwd.cu)."""
    wide_class(h)
    return _WIDE_TILE


def table_eval(coef: torch.Tensor, x: torch.Tensor, lo: torch.Tensor,
               hi: torch.Tensor) -> torch.Tensor:
    """One step's hoisted table: (P, D) piecewise or (C,) Chebyshev."""
    if coef.ndim == 2:
        return pw_eval(coef, x, lo, hi)
    return cheb_eval(coef, x, lo, hi)


def rollout_plain(model, gam_params, y0, tables, dw, j,
                  time_scale: float = 1.0, activation=torch.tanh,
                  x_prop: bool = False, residuals: bool = False,
                  head_tf32: bool = False, gamma=None, price=None, z=None,
                  scan=None):
    """(x_N, y_N) of the hoisted global rollout, step by step.

    ``tables`` holds "lo", "hi" (N,) and "cc", "pc", "zc" per step; dw and j
    are (N, B).  Each step is the body of the global scheme's time loop with
    the model's own callables (f, step), so autograd of this function is the
    reference gradient.  ``x_prop`` is the pure-jump regime: the Γ net reads
    (t, x, x·J), and there is no Z table, the model's step takes no dW, and
    dw is the zero-width (N, 0) placeholder.  With ``residuals`` it returns
    (x_N, y_N, xs, ys), xs and ys the (N, B) residuals kernel B1 saves for
    B2: x before each step, y after each step's update.  ``head_tf32`` runs
    the head's H×H layer as a TF32 product (``gamma_head``).

    The solver's hoisted loop and the hand-written adjoint's forward are
    this loop too, through hooks: ``gamma(i, x, j_i)`` takes the place of
    the Γ head on ``gam_params``, ``price(i, x)`` of the "pc" table (None:
    the model's own pricer), ``z(i, x)`` of the "zc" table, and
    ``scan(body, carry, n) -> (carry, per-step outputs)`` of the plain loop
    (the solver's chunked time loop, ``ops/scan.py``)."""
    n, batch = j.shape
    dt = model.dt

    def table(name):
        return lambda i, x: table_eval(tables[name][i], x, tables["lo"][i],
                                       tables["hi"][i])

    if gamma is None:
        def gamma(i, x, ji):
            t = torch.full_like(x, float(i)) * time_scale
            feat = x * ji if x_prop else ji
            return gamma_head(gam_params, torch.stack([t, x, feat], -1),
                              activation, head_tf32)[..., 0]
    comp = table("cc")
    price = table("pc") if price is None else price
    z = table("zc") if z is None else z

    def body(carry, i):
        x, y = carry
        gam = gamma(i, x, j[i])
        y = y - dt * model.f(y) + gam - comp(i, x)
        a = price(i, x)
        if not x_prop:
            y = y + z(i, x) * dw[i]
        if x_prop:
            x_next = model.step(i, x, j[i], y, price=a)
        else:
            x_next = model.step(i, x, dw[i], j[i], y, price=a)
        return (x_next, y), ((x, y) if residuals else None)

    x = model.init_x(batch, j.device)
    y = y0 * torch.ones((batch,), dtype=torch.float32, device=j.device)
    if scan is None:
        scan = lambda body, carry, n: chunked_scan(body, carry, range(n), n)
    (x, y), path = scan(body, (x, y), n)
    if residuals:
        return x, y, path[0], path[1]
    return x, y


def merton_form_constants(model):
    """(r, a_lin, sigma, drift, x0) if the model has the exact Merton forms
    the kernels bake in — f(y) = −r y, coupling(u) = aLin |u|, log-increments
    drift + σ dW + J — else None.  The check probes the model's own
    callables, so a model with other dynamics fails it even when the
    attributes exist."""
    try:
        r = float(model.r)
        sigma = float(model.sigma)
        x0 = float(model.x0)
        u = torch.tensor([-3.0, -1.0, 0.5, 2.0])
        cu = np.asarray(model.coupling(u))
        a_lin = float(cu[1])
        if not np.allclose(cu, a_lin * np.abs(u.numpy()), rtol=1e-6,
                           atol=1e-12):
            return None
        fu = np.asarray(model.f(u))
        if not np.allclose(fu, -r * u.numpy(), rtol=1e-6, atol=1e-12):
            return None
        z = torch.zeros(())
        one = torch.ones(())
        two = torch.full((), 2.0)
        inc = lambda a, b: float(model.uncoupled_log_increments(a, b))
        drift = inc(z, z)
        # The three on-axis points pin the affine coefficients, (1, 1)
        # falsifies a dW·J cross term, (2, 0) and (0, 2) quadratic terms.
        if not (np.isclose(inc(one, z), drift + sigma, rtol=1e-6)
                and np.isclose(inc(z, one), drift + 1.0, rtol=1e-6)
                and np.isclose(inc(one, one), drift + sigma + 1.0, rtol=1e-6)
                and np.isclose(inc(two, z), drift + 2.0 * sigma, rtol=1e-6)
                and np.isclose(inc(z, two), drift + 2.0, rtol=1e-6)):
            return None
        return r, a_lin, sigma, drift, x0
    except Exception:
        return None


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """What the kernels bake in: the Merton constants, widths and the time
    feature's scale."""

    hidden: int
    n_pieces: int
    time_scale: float
    r: float
    a_lin: float
    sigma: float
    drift: float
    x0: float
    dt: float
    head_tf32: bool = False

    def scalars(self, wide: bool = False) -> list:
        """The float arguments of the C entry points, in order: the
        specialised kernels take the growth 1 + r·dt, the wide kernels r·dt
        (csrc/rollout_wide.cuh ``Consts``)."""
        f = ctypes.c_float
        r_dt = self.r * self.dt
        return [f(self.time_scale), f(r_dt if wide else 1.0 + r_dt),
                f(self.a_lin), f(self.dt), f(self.sigma), f(self.drift)]


def _check(name, t, shape, device):
    """Raise unless ``t`` is a contiguous float32 tensor of ``shape`` on
    ``device``."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name}: dtype {t.dtype}, expected torch.float32")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _check_sizes(n: int, batch: int, h: int, p: int) -> None:
    """The kernels index in 32-bit ints the path-steps (N·B), the paths up
    to the end of their last tile (at most 128 wide, 256 in the wide B1),
    and B2's partial rows of H² + 6H + 1 + N·3·P·D floats."""
    tile = _B2_TILE if h in KERNEL_WIDTHS else _WIDE_B1_MAX_TILE
    if (n * batch >= 2**31 or batch > 2**31 - tile
            or b2_partial_shape(n, batch, h, p)[1] >= 2**31):
        raise ValueError("the rollout does not fit the kernels' 32-bit "
                         "indices")


def _check_inputs(spec, weights, tables, dw, j, wide: bool = False):
    """Shared validation of the kernels' inputs (the specialised kernels',
    or with ``wide`` the wide kernels'); returns (n, batch)."""
    if dw.device.type != "cuda":
        raise ValueError(f"the rollout kernels take CUDA tensors, got "
                         f"{dw.device}")
    h = spec.hidden
    if wide:
        wide_class(h)
        if h in KERNEL_WIDTHS:
            raise ValueError(f"hidden widths {KERNEL_WIDTHS} have their "
                             f"specialised rollout kernels, got {h}")
    elif h not in KERNEL_WIDTHS:
        raise ValueError(f"the specialised rollout kernels are built for "
                         f"hidden widths {KERNEL_WIDTHS}, got {h}")
    if dw.ndim != 2 or dw.shape[0] < 1 or dw.shape[1] < 1:
        raise ValueError(f"dw: expected (N, B) with N, B >= 1, got "
                         f"{tuple(dw.shape)}")
    n, batch = dw.shape
    p, d, dev = spec.n_pieces, KERNEL_COEFFS, dw.device
    _check_sizes(n, batch, h, p)
    _check("j", j, (n, batch), dev)
    _check("dw", dw, (n, batch), dev)
    for name in ("cc", "pc", "zc"):
        _check(name, tables[name], (n, p, d), dev)
    _check("lo", tables["lo"], (n,), dev)
    _check("hi", tables["hi"], (n,), dev)
    for name, t, shape in zip(("W1", "b1", "W2", "b2", "W3"), weights,
                              ((3, h), (h,), (h, h), (h,), (h, 1))):
        _check(name, t, shape, dev)
    return n, batch


def _ptr(t):
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


def _lib(name, nptr, nint, nfloat):
    """The kernel library with its C entry's argument types declared."""
    from deepfbsdejsolvers_torch.ops import _build

    lib = _build.load(name)
    fn = getattr(lib, name)
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * nptr + [ctypes.c_int] * nint
                   + [ctypes.c_float] * nfloat + [ctypes.c_void_p])
    return fn


def _launch_fwd(name: str, wide: bool, spec, weights, y0, tables, dw, j,
                save: bool):
    """Launch the forward kernel of library ``name``; returns (x_N, y_N,
    xs, ys)."""
    n, batch = _check_inputs(spec, weights, tables, dw, j, wide=wide)
    _check("y0", y0, (), dw.device)
    fn = _lib(name, 17, 5, 7)
    kw = dict(dtype=torch.float32, device=dw.device)
    xn = torch.empty((batch,), **kw)
    yn = torch.empty((batch,), **kw)
    xs = torch.empty((n, batch), **kw) if save else None
    ys = torch.empty((n, batch), **kw) if save else None
    with torch.cuda.device(dw.device):    # launch on the tensors' card
        stream = torch.cuda.current_stream(dw.device).cuda_stream
        rc = fn(*map(_ptr, (dw, j, tables["cc"], tables["pc"], tables["zc"],
                            tables["lo"], tables["hi"], *weights, y0, xn, yn,
                            xs, ys)),
                n, batch, spec.n_pieces, spec.hidden, int(spec.head_tf32),
                *spec.scalars(wide), ctypes.c_float(spec.x0),
                ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")
    return xn, yn, xs, ys


def _count(wrapper, spec: KernelSpec) -> None:
    """One launch of ``wrapper``'s kernel in ``spec``'s instance."""
    wrapper.launches += 1
    wrapper.launches_tf32 += int(spec.head_tf32)


def b1_forward(spec: KernelSpec, weights, y0, tables, dw, j, save: bool):
    """Kernel B1: the whole N-step forward, one thread per path.

    ``weights`` = (W1, b1, W2, b2, W3) with b3 already folded into
    ``tables["cc"]``.  Returns (x_N, y_N, xs, ys); xs (x before each step)
    and ys (y after each step's update) are (N, B) residuals for B2, or None
    when ``save`` is false."""
    out = _launch_fwd("rollout_fwd", False, spec, weights, y0, tables, dw, j,
                      save)
    _count(b1_forward, spec)
    return out


b1_forward.launches = b1_forward.launches_tf32 = 0


def b1_wide_forward(spec: KernelSpec, weights, y0, tables, dw, j,
                    save: bool):
    """Kernel B1 at every hidden width up to ``ROLLOUT_MAX_WIDTH`` bar
    ``KERNEL_WIDTHS``: each warp carries a few paths through the N steps,
    its lanes sharing the hidden units, the head's sums in the plain
    version's f32 order, one register-tiled kernel for both instances.
    Arguments and returns as ``b1_forward``."""
    out = _launch_fwd("rollout_wide_fwd", True, spec, weights, y0, tables,
                      dw, j, save)
    _count(b1_wide_forward, spec)
    return out


b1_wide_forward.launches = b1_wide_forward.launches_tf32 = 0


def b2_blocks(batch: int) -> int:
    """Thread blocks of B2 for ``batch`` paths: one per 128-path tile up to
    a fixed maximum, each block walking its tiles in order."""
    return min(-(-batch // _B2_TILE), _B2_MAX_BLOCKS)


def b2_wide_blocks(batch: int, h: int, tf32: bool = False) -> int:
    """Thread blocks of the wide B2 (its head-TF32 instance with ``tf32``)
    for ``batch`` paths at hidden width ``h``: one per tile up to the
    blocks the card holds at once at the width class, each walking its
    tiles in order."""
    cap = _WIDE_B2_BLOCKS_PER_SM[wide_class(h), bool(tf32)] * _SMS
    return min(-(-batch // wide_tile(h)), cap)


def b2_partial_shape(n: int, batch: int, h: int, p: int,
                     tf32: bool = False):
    """(blocks, floats per block) of the partial buffer of the B2 of hidden
    width ``h`` (the specialised one at ``KERNEL_WIDTHS``, the wide one
    elsewhere, its head-TF32 instance with ``tf32``): the Γ head's
    cotangents, ȳ0 and the N steps' table cotangents of each block,
    whatever the batch."""
    blocks = b2_blocks(batch) if h in KERNEL_WIDTHS else b2_wide_blocks(
        batch, h, tf32)
    return blocks, h * h + 6 * h + 1 + n * 3 * p * KERNEL_COEFFS


def _launch_bwd(name: str, wide: bool, spec, weights, tables, dw, j, xs, ys,
                cxn, cyn):
    """Launch the backward kernel of library ``name`` and its block-order
    reduction; returns the flat cotangent vector."""
    n, batch = _check_inputs(spec, weights, tables, dw, j, wide=wide)
    for what, t, shape in (("xs", xs, (n, batch)), ("ys", ys, (n, batch)),
                           ("x_N cotangent", cxn, (batch,)),
                           ("y_N cotangent", cyn, (batch,))):
        _check(what, t, shape, dw.device)
    n_blocks, n_out = b2_partial_shape(n, batch, spec.hidden, spec.n_pieces,
                                       spec.head_tf32)
    fn = _lib(name, 18, 6, 6)
    kw = dict(dtype=torch.float32, device=dw.device)
    partials = torch.empty((n_blocks, n_out), **kw)
    out = torch.empty((n_out,), **kw)
    with torch.cuda.device(dw.device):
        stream = torch.cuda.current_stream(dw.device).cuda_stream
        rc = fn(*map(_ptr, (dw, j, tables["cc"], tables["pc"], tables["zc"],
                            tables["lo"], tables["hi"], *weights, xs, ys,
                            cxn, cyn, partials, out)),
                n, batch, spec.n_pieces, spec.hidden, n_blocks,
                int(spec.head_tf32), *spec.scalars(wide),
                ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")
    return out


def b2_backward(spec: KernelSpec, weights, tables, dw, j, xs, ys, cxn, cyn):
    """Kernel B2: the reverse adjoint replay over the saved (xs, ys) by at
    most ``b2_blocks(B)`` blocks walking 128-path tiles, each summing its
    paths' cotangents in registers and per step in shared memory, then a
    second kernel that sums the per-block partials in block order.

    Returns one flat vector: [dW2 (H·H, row h1 × column out) | db2 | dW3 |
    db1 | dW1 rows t, x, j (3·H) | ȳ0 | table cotangents (N, 3, P, D) for
    cc, pc, zc]."""
    out = _launch_bwd("rollout_bwd", False, spec, weights, tables, dw, j, xs,
                      ys, cxn, cyn)
    _count(b2_backward, spec)
    return out


b2_backward.launches = b2_backward.launches_tf32 = 0


def b2_wide_backward(spec: KernelSpec, weights, tables, dw, j, xs, ys, cxn,
                     cyn):
    """Kernel B2 at every hidden width up to ``ROLLOUT_MAX_WIDTH`` bar
    ``KERNEL_WIDTHS``: at most ``b2_wide_blocks(B, H)`` blocks walk their
    128-path tiles in order, each warp replaying 16 paths, the head's three
    H×H products (h1ᵀ·dp2 block-wide) on the tensor cores in split TF32
    (the head-TF32 instance: one TF32 pass),
    the table cotangents summed per step in a fixed order; a second kernel
    sums the blocks' partials in block order.  Arguments and returns as
    ``b2_backward``."""
    out = _launch_bwd("rollout_wide_bwd", True, spec, weights, tables, dw, j,
                      xs, ys, cxn, cyn)
    _count(b2_wide_backward, spec)
    return out


b2_wide_backward.launches = b2_wide_backward.launches_tf32 = 0


def rollout_kernels(h: int):
    """(forward, backward) kernels of hidden width ``h``: the specialised
    B1/B2 at ``KERNEL_WIDTHS``, the wide ones at every other width."""
    if h in KERNEL_WIDTHS:
        return b1_forward, b2_backward
    return b1_wide_forward, b2_wide_backward


def b2_cotangents(out, spec: KernelSpec, n: int):
    """B2's flat output as the cotangents of (W1, b1, W2, b2, W3, b3, y0,
    cc, pc, zc): b3's from the compensator table's T_0 row, into which the
    caller folded it (``_fold_b3``)."""
    h, p = spec.hidden, spec.n_pieces
    o = h * h
    dw2 = out[:o].view(h, h)
    db2 = out[o:o + h]
    dw3 = out[o + h:o + 2 * h].view(h, 1)
    db1 = out[o + 2 * h:o + 3 * h]
    dw1 = out[o + 3 * h:o + 6 * h].view(3, h)
    dy0 = out[o + 6 * h]
    tab = out[o + 6 * h + 1:].view(n, 3, p, KERNEL_COEFFS)
    dcc, dpc, dzc = tab[:, 0], tab[:, 1], tab[:, 2]
    db3 = -dcc[..., 0].sum().reshape(1)
    return dw1, db1, dw2, db2, dw3, db3, dy0, dcc, dpc, dzc


def _fold_b3(cc, b3):
    """cc with the Γ output bias folded into each piece's T_0 coefficient:
    (Γ + b3) − comp == Γ − (comp − b3), so the kernels never see b3."""
    ccf = cc.clone()
    ccf[..., 0] -= b3[0]
    return ccf


class FusedRollout(torch.autograd.Function):
    """B1 forward with residuals, B2 backward, of the build for the head's
    width: the rollout's gradients with respect to the Γ head, y0 and the
    three tables."""

    @staticmethod
    def forward(ctx, spec, w1, b1, w2, b2, w3, b3, y0, cc, pc, zc, lo, hi,
                dw, j):
        tables = {"cc": _fold_b3(cc, b3), "pc": pc, "zc": zc, "lo": lo,
                  "hi": hi}
        weights = (w1, b1, w2, b2, w3)
        xn, yn, xs, ys = rollout_kernels(spec.hidden)[0](
            spec, weights, y0, tables, dw, j, save=True)
        ctx.spec = spec
        ctx.save_for_backward(*weights, tables["cc"], pc, zc, lo, hi, dw, j,
                              xs, ys)
        return xn, yn

    @staticmethod
    def backward(ctx, gxn, gyn):
        spec = ctx.spec
        w1, b1, w2, b2, w3, ccf, pc, zc, lo, hi, dw, j, xs, ys = \
            ctx.saved_tensors
        gxn = torch.zeros_like(xs[0]) if gxn is None else gxn.contiguous()
        gyn = torch.zeros_like(xs[0]) if gyn is None else gyn.contiguous()
        tables = {"cc": ccf, "pc": pc, "zc": zc, "lo": lo, "hi": hi}
        out = rollout_kernels(spec.hidden)[1](
            spec, (w1, b1, w2, b2, w3), tables, dw, j, xs, ys, gxn, gyn)
        return (None, *b2_cotangents(out, spec, dw.shape[0]), None, None,
                None, None)


class FusedRolloutOp:
    """``rollout(gam_params, y0, tables, dw, j) -> (x_N, y_N)``: the plain
    loop on CPU tensors, the B1/B2 kernels of the head's width on CUDA
    tensors, their instance of ``head_precision`` ("highest" or
    "default")."""

    def __init__(self, model, hidden: int, time_scale: float = 1.0,
                 n_pieces: int = 8, degree: int = 7,
                 head_precision: str = "highest"):
        consts = merton_form_constants(model)
        if consts is None:
            raise ValueError("the fused rollout requires a Merton-form model "
                             "(see merton_form_constants)")
        if not 1 <= hidden <= ROLLOUT_MAX_WIDTH:
            raise ValueError(f"the fused rollout kernels take hidden widths "
                             f"1..{ROLLOUT_MAX_WIDTH}, got {hidden}")
        if degree + 1 != KERNEL_COEFFS:
            raise ValueError(f"the fused rollout kernels take degree "
                             f"{KERNEL_COEFFS - 1} tables, got {degree}")
        r, a_lin, sigma, drift, x0 = consts
        self.model = model
        self.spec = KernelSpec(hidden=hidden, n_pieces=n_pieces,
                               time_scale=float(time_scale), r=r,
                               a_lin=a_lin, sigma=sigma, drift=drift, x0=x0,
                               dt=float(model.dt),
                               head_tf32=head_tf32_of(head_precision))

    def plain(self, gam_params, y0, tables, dw, j):
        """``rollout_plain`` with this operator's model, time scale and
        head precision."""
        return rollout_plain(self.model, gam_params, y0, tables, dw, j,
                             self.spec.time_scale,
                             head_tf32=self.spec.head_tf32)

    def __call__(self, gam_params, y0, tables, dw, j):
        if dw.device.type == "cpu":
            return self.plain(gam_params, y0, tables, dw, j)
        (w1, w2, w3), (b1, b2, b3) = gam_params["W"], gam_params["b"]
        args = (w1, b1, w2, b2, w3, b3, y0, tables["cc"], tables["pc"],
                tables["zc"], tables["lo"], tables["hi"])
        args = tuple(a.contiguous() for a in args) + (dw.contiguous(),
                                                      j.contiguous())
        if torch.is_grad_enabled() and any(a.requires_grad for a in args):
            return FusedRollout.apply(self.spec, *args)
        w1, b1, w2, b2, w3, b3, y0, cc, pc, zc, lo, hi, dw, j = args
        tables = {"cc": _fold_b3(cc, b3), "pc": pc, "zc": zc, "lo": lo,
                  "hi": hi}
        xn, yn, _, _ = rollout_kernels(self.spec.hidden)[0](
            self.spec, (w1, b1, w2, b2, w3), y0, tables, dw, j, save=False)
        return xn, yn
