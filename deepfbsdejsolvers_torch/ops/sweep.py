"""The compensator sweep with a rank-1 first layer: plain and CUDA kernels.

The un-hoisted schemes need, every step, the weighted sweep of a Γ head
over a node set {(J_m, w_m)}: Σ_m w_m·Γ(t, x_b, J_m) for every path b.  The
head is a Γ net [t, x, f] (3 → H → H → 1, tanh), with the node feature f
constant per node (J, e^J) or x·J in the pure-jump regime, or the
pure-jump U-net [t, x·(1 + J)] (2 → H → H → 1).  Either way x enters the
first layer linearly, so at node m that layer is tanh(x_b·a_m + c_m) with
per-node vectors a_m, c_m (``rank1_three_feature``,
``rank1_two_feature``), and the weights fold into the output column,
v_m = w_m·W2[:, 0].  What is left,

    out_b = Σ_m Σ_k v[m,k]·tanh(Σ_h tanh(x_b·a[m,h] + c[m,h])·W1[h,k] + b1[k]),

plus the folded bias wb2 = Σ_m w_m·b2, is computed by ``sweep_plain`` in
PyTorch (the CPU path, and the oracle the kernels are held against) and by
two CUDA kernels on the card: B3, the forward, and B4, the backward, behind
the ``FusedSweep`` autograd function.  They come in two builds: specialised
at the hidden widths ``KERNEL_WIDTHS`` (8 and 21; ``csrc/sweep_fwd.cu``,
``csrc/sweep_bwd.cu``), and wide at every other width up to
``SWEEP_MAX_WIDTH`` (``csrc/sweep_wide_fwd.cu``, ``csrc/sweep_wide_bwd.cu``,
zero-padded to a width class of 32, 64 or 128, their H×H products on the
tensor cores in split TF32), each with its own launch count.
``fused_sweep`` dispatches on the device of its input: the plain sweep on
CPU tensors, the kernels on CUDA tensors, and no fallback from the kernels
to the plain sweep.
"""

from __future__ import annotations

import torch

from deepfbsdejsolvers_torch.ops.rollout import (
    KERNEL_WIDTHS, ROLLOUT_MAX_WIDTH, _check, _lib, _ptr, wide_class)

# Paths per tile of both kernels (128 threads of two paths each), and the
# most blocks B4 launches: together they fix the order of B4's sums and
# bound its partial buffer (csrc/sweep_bwd.cu BWD_TILE).
_TILE = 256
_B4_MAX_BLOCKS = 512
# The widest head the wide kernels take (the JAX package's Pallas sweep
# takes two equal tanh layers up to 128 wide; ``wide_class`` gives the width
# class each pads to, as the wide rollout's), the wide B4's paths per block
# (eight warps of one m16 tile of 16 paths, at every width class), and the
# most blocks it launches, two per SM of an H100 (csrc/sweep_wide.cuh,
# csrc/sweep_wide_bwd.cu).
SWEEP_MAX_WIDTH = ROLLOUT_MAX_WIDTH
_WIDE_TILE = 128
_WIDE_B4_MAX_BLOCKS = 2 * 132


def rank1_three_feature(head, t, feat, x_prop: bool, weights):
    """(a, c, v, wb2) of the Γ head ``head`` swept over nodes with feature
    ``feat`` (M,) and weights (M,) at time feature ``t``.

    With W0 (3, H) the first layer's rows (t, x, f):
      x_prop=False (f = J):    a = W0[x],          c = t·W0[t] + f·W0[f] + b0
      x_prop=True  (f = x·J):  a = W0[x] + f·W0[f], c = t·W0[t] + b0
    a, c, v are (M, H); v = w·W2[:, 0]; wb2 = Σ w·b2 is added to the sweep
    outside.  Differentiable, so the sweep's cotangents of a, c and v reach
    W0, b0, W2 and b2 through autograd."""
    w0, b0 = head["W"][0], head["b"][0]
    w2, b2 = head["W"][2], head["b"][2]
    fcol = feat[:, None] * w0[2][None, :]
    base_c = t * w0[0] + b0
    if x_prop:
        a = w0[1][None, :] + fcol
        c = base_c[None, :].expand_as(a)
    else:
        c = base_c[None, :] + fcol
        a = w0[1][None, :].expand_as(c)
    v = weights[:, None] * w2[:, 0][None, :]
    return a, c, v, weights.sum() * b2[0]


def rank1_two_feature(head, t, phi, weights):
    """(a, c, v, wb2) of a one-output head on [t, x·φ] swept over nodes
    with factor ``phi`` (M,) and weights (M,) at time feature ``t``: the
    pure-jump U-net's Γ = U(t, X + X·J), φ = 1 + J.  With W0 (2, H) the
    first layer's rows (t, x):  a = φ·W0[x],  c = t·W0[t] + b0;  v and wb2
    as in ``rank1_three_feature``."""
    w0, b0 = head["W"][0], head["b"][0]
    w2, b2 = head["W"][2], head["b"][2]
    a = phi[:, None] * w0[1][None, :]
    c = (t * w0[0] + b0)[None, :].expand_as(a)
    v = weights[:, None] * w2[:, 0][None, :]
    return a, c, v, weights.sum() * b2[0]


def sweep_plain(x, a, c, w1, b1, v):
    """out_b = Σ_m Σ_k v[m,k]·tanh(tanh(x_b·a[m] + c[m]) @ W1 + b1)[k], in
    PyTorch on an [M, B, H] grid; x (B,), a, c, v (M, H), w1 (H, H), b1 (H,)."""
    h1 = torch.tanh(x[None, :, None] * a[:, None, :] + c[:, None, :])
    h2 = torch.tanh(torch.matmul(h1, w1) + b1)
    return (h2 * v[:, None, :]).sum(dim=(0, 2))


def _check_sizes(batch: int, m: int, h: int) -> None:
    """The kernels index in 32-bit ints the paths, and B4's partial rows of
    H² + H + 3·M·H floats, up to the end of their last 256-wide tile."""
    if max(batch, h * h + h + 3 * m * h) > 2**31 - _TILE:
        raise ValueError("the sweep does not fit the kernels' 32-bit "
                         "indices")


def _check_sweep(x, a, c, w1, b1, v, wide: bool = False):
    """Shared validation of the kernels' inputs (the specialised kernels',
    or with ``wide`` the wide kernels'); returns (batch, m, h)."""
    if x.device.type != "cuda":
        raise ValueError(f"the sweep kernels take CUDA tensors, got "
                         f"{x.device}")
    if x.ndim != 1 or x.shape[0] < 1:
        raise ValueError(f"x: expected (B,) with B >= 1, got "
                         f"{tuple(x.shape)}")
    if a.ndim != 2 or a.shape[0] < 1:
        raise ValueError(f"a: expected (M, H) with M >= 1, got "
                         f"{tuple(a.shape)}")
    (batch,), (m, h), dev = x.shape, a.shape, x.device
    if wide:
        wide_class(h)
        if h in KERNEL_WIDTHS:
            raise ValueError(f"hidden widths {KERNEL_WIDTHS} have their "
                             f"specialised sweep kernels, got {h}")
    elif h not in KERNEL_WIDTHS:
        raise ValueError(f"the specialised sweep kernels are built for "
                         f"hidden widths {KERNEL_WIDTHS}, got {h}")
    _check_sizes(batch, m, h)
    for name, t, shape in (("x", x, (batch,)), ("a", a, (m, h)),
                           ("c", c, (m, h)), ("w1", w1, (h, h)),
                           ("b1", b1, (h,)), ("v", v, (m, h))):
        _check(name, t, shape, dev)
    return batch, m, h


def _launch_fwd(name: str, wide: bool, x, a, c, w1, b1, v):
    """Launch the forward kernel of library ``name``; returns out (B,)."""
    batch, m, h = _check_sweep(x, a, c, w1, b1, v, wide=wide)
    fn = _lib(name, 7, 3, 0)
    out = torch.empty((batch,), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(*map(_ptr, (x, a, c, w1, b1, v, out)), batch, m, h,
                stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")
    return out


def _launch_bwd(name: str, wide: bool, x, a, c, w1, b1, v, g):
    """Launch the backward kernel of library ``name`` and its block-order
    reduction; returns (dx, da, dc, dw1, db1, dv)."""
    batch, m, h = _check_sweep(x, a, c, w1, b1, v, wide=wide)
    _check("g", g, (batch,), x.device)
    n_blocks, n_out = b4_partial_shape(batch, m, h)
    fn = _lib(name, 10, 4, 0)
    kw = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty((batch,), **kw)
    part = torch.empty((n_blocks, n_out), **kw)
    out = torch.empty((n_out,), **kw)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(*map(_ptr, (x, a, c, w1, b1, v, g, dx, part, out)), batch,
                m, h, n_blocks, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")
    dw1 = out[:h * h].view(h, h)
    db1 = out[h * h:h * h + h]
    da, dc, dv = out[h * h + h:].view(3, m, h)
    return dx, da, dc, dw1, db1, dv


def b3_forward(x, a, c, w1, b1, v):
    """Kernel B3: the sweep's forward, each thread carrying a few paths
    through the nodes in order.  Returns out (B,)."""
    out = _launch_fwd("sweep_fwd", False, x, a, c, w1, b1, v)
    b3_forward.launches += 1
    return out


b3_forward.launches = 0


def b3_wide_forward(x, a, c, w1, b1, v):
    """Kernel B3 at every hidden width up to ``SWEEP_MAX_WIDTH`` bar
    ``KERNEL_WIDTHS``: each warp carries a few paths through the nodes in
    order, its H×H product on the tensor cores in split TF32.  Returns out
    (B,)."""
    out = _launch_fwd("sweep_wide_fwd", True, x, a, c, w1, b1, v)
    b3_wide_forward.launches += 1
    return out


b3_wide_forward.launches = 0


def b4_blocks(batch: int) -> int:
    """Thread blocks of B4 for ``batch`` paths: one per 256-path tile up to
    a fixed maximum, each block walking its tiles in order."""
    return min(-(-batch // _TILE), _B4_MAX_BLOCKS)


def b4_wide_tile() -> int:
    """Paths per block of the wide B4: eight warps of 16 paths, the rows of
    their tensor-core tiles, at every width class."""
    return _WIDE_TILE


def b4_wide_blocks(batch: int, h: int) -> int:
    """Thread blocks of the wide B4 for ``batch`` paths at hidden width
    ``h``: one per tile up to a fixed maximum, each walking its tiles in
    order."""
    wide_class(h)
    return min(-(-batch // _WIDE_TILE), _WIDE_B4_MAX_BLOCKS)


def b4_partial_shape(batch: int, m: int, h: int):
    """(blocks, floats per block) of the partial buffer of the B4 of hidden
    width ``h`` (the specialised one at ``KERNEL_WIDTHS``, the wide one
    elsewhere): dW1, db1 and the per-node da, dc, dv of each block,
    whatever the batch."""
    blocks = b4_blocks(batch) if h in KERNEL_WIDTHS else b4_wide_blocks(
        batch, h)
    return blocks, h * h + h + 3 * m * h


def b4_backward(x, a, c, w1, b1, v, g):
    """Kernel B4: the sweep's backward for the cotangent ``g`` (B,).  It
    recomputes each path's hidden layers per node, keeps dx in the thread,
    and sums the weight cotangents over paths per block (dW1 and db1 as a
    register-tiled product, da, dc and dv by warp shuffles); a second kernel
    sums the blocks' partials in block order.  Returns
    (dx, da, dc, dw1, db1, dv)."""
    grads = _launch_bwd("sweep_bwd", False, x, a, c, w1, b1, v, g)
    b4_backward.launches += 1
    return grads


b4_backward.launches = 0


def b4_wide_backward(x, a, c, w1, b1, v, g):
    """Kernel B4 at every hidden width up to ``SWEEP_MAX_WIDTH`` bar
    ``KERNEL_WIDTHS``, for the cotangent ``g`` (B,): each warp recomputes
    its paths' hidden layers and their backward, the block sums dW1 over its
    paths and da, dc, dv over its warps in order, the three H×H products on
    the tensor cores in split TF32; a second kernel sums the blocks'
    partials in block order.  Returns (dx, da, dc, dw1, db1, dv)."""
    grads = _launch_bwd("sweep_wide_bwd", True, x, a, c, w1, b1, v, g)
    b4_wide_backward.launches += 1
    return grads


b4_wide_backward.launches = 0


def sweep_kernels(h: int):
    """(forward, backward) kernels of hidden width ``h``: the specialised
    B3/B4 at ``KERNEL_WIDTHS``, the wide ones at every other width."""
    if h in KERNEL_WIDTHS:
        return b3_forward, b4_backward
    return b3_wide_forward, b4_wide_backward


class FusedSweep(torch.autograd.Function):
    """B3 forward, B4 backward, of the build for the head's width.  Only
    the inputs are saved: B4 recomputes the hidden layers, so no [M, B, H]
    activation outlives the call."""

    @staticmethod
    def forward(ctx, x, a, c, w1, b1, v):
        ctx.save_for_backward(x, a, c, w1, b1, v)
        return sweep_kernels(a.shape[1])[0](x, a, c, w1, b1, v)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        return sweep_kernels(saved[1].shape[1])[1](*saved, g.contiguous())


def fused_sweep(x, a, c, w1, b1, v):
    """The sweep ``out`` (B,): ``sweep_plain`` on CPU tensors, kernels B3
    (and B4 under autograd) on CUDA tensors."""
    if x.device.type == "cpu":
        return sweep_plain(x, a, c, w1, b1, v)
    args = tuple(t.contiguous() for t in (x, a, c, w1, b1, v))
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return FusedSweep.apply(*args)
    return sweep_kernels(a.shape[1])[0](*args)
