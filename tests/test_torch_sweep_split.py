"""The split-TF32 arithmetic of the wide sweep kernels, emulated on the CPU.

The wide B3/B4 (``csrc/sweep_wide_fwd.cu``, ``csrc/sweep_wide_bwd.cu``) run
the sweep's three H×H products on the tensor cores in TF32: each f32 operand
is split into hi, a rounded to TF32 (to nearest at 10 mantissa bits), and
lo = a − hi, which the tensor cores read truncated to TF32, and a·b is
formed as hi·hi + hi·lo + lo·hi with f32 sums.  Here that arithmetic is
emulated in PyTorch (the TF32 rounding and truncation on the bits, the
products in f32, whose products of two TF32 values are exact) and the
sweep's forward and its gradients, the products
h1·W1, dz2·W1ᵀ and h1ᵀ·dz2 taken that way and the rest in f32 as the
kernels take it, are held to a float64 evaluation of ``sweep_plain`` within
the tolerances ``chip_smoke.py`` holds the kernels to on the card: out to
1e-5 of max |out|, each gradient leaf and their global norm to 1e-4
relative.  One TF32 pass (tf32(a)·tf32(b)) misses them.  These tests check
the split-TF32 rounding of the products, each taken as one f32 matmul over
all its terms, not the order in which the kernels sum them; that order is
the card's to check (``chip_smoke.py``'s wide checks and ``F64_CHECK``).
Only dW1, whose sum over paths and nodes is the longest, is also taken in
B4w's order (``dw1_b4w_order``: one fragment per node and 128-path tile in
k-steps of 8, f32 running sums flushed to the block's partial every 16
nodes, the partials summed in block order), the tensor cores' own
accumulation inside a k-step emulated by an f32 sum.  The inputs are the
parity path's: the Merton 49-node quadrature in rank-1 form with a Γ head
of seeded weights, 1024 spots, at hidden 20, 64 and 128."""

import functools
import math

import numpy as np
import pytest
import torch

from deepfbsdejsolvers_torch.models.merton import make_merton_default
from deepfbsdejsolvers_torch.ops.compensator import CompensatorSpec
from deepfbsdejsolvers_torch.ops.sweep import (
    rank1_three_feature, sweep_plain)

BATCH = 1024
FWD_TOL, GRAD_TOL = 1e-5, 1e-4
LEAVES = ("x", "a", "c", "W1", "b1", "v")


def tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 ``x`` rounded to TF32: to nearest at 10 mantissa bits, ties away
    from zero (as ``cvt.rna.tf32.f32``), as an f32 whose low 13 bits are
    0."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_read(x: torch.Tensor) -> torch.Tensor:
    """The TF32 value the tensor cores read from an f32 register: its low
    13 bits dropped."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def mm_split(a, b):
    """a @ b in split TF32 as the kernels take it: hi = tf32(a), lo = a − hi
    read as TF32; hi·hi + (hi·lo + lo·hi), f32 sums."""
    ah, bh = tf32(a), tf32(b)
    al, bl = tf32_read(a - ah), tf32_read(b - bh)
    return ah @ bh + (ah @ bl + al @ bh)


def mm_one(a, b):
    """a @ b in one TF32 pass."""
    return tf32_read(a) @ tf32_read(b)


def sweep_emulated(mm, x, a, c, w1, b1, v, g):
    """(out, (dx, da, dc, dW1, db1, dv)) of the sweep for the cotangent g,
    in f32 as the wide kernels compute it, the three products by ``mm``."""
    h1 = torch.tanh(x[None, :, None] * a[:, None, :] + c[:, None, :])
    h2 = torch.tanh(mm(h1, w1) + b1)
    out = (h2 * v[:, None, :]).sum(dim=(0, 2))
    dz2 = (g[None, :, None] * v[:, None, :]) * (1.0 - h2 * h2)
    dz1 = mm(dz2, w1.T.contiguous()) * (1.0 - h1 * h1)
    dx = (dz1 * a[:, None, :]).sum(dim=(0, 2))
    da = (dz1 * x[None, :, None]).sum(dim=1)
    dc = dz1.sum(dim=1)
    dv = (g[None, :, None] * h2).sum(dim=1)
    m, n, h = h1.shape
    dw1 = mm(h1.reshape(m * n, h).T.contiguous(), dz2.reshape(m * n, h))
    db1 = dz2.sum(dim=(0, 1))
    return out, (dx, da, dc, dw1, db1, dv)


def dw1_b4w_order(h1, dz2, tile=128, chunk=16):
    """dW1 = Σ h1ᵀ·dz2 over nodes and paths in the order of B4w
    (``csrc/sweep_wide_bwd.cu``) with one block per ``tile`` paths: per node
    and tile a fresh fragment, over k-steps of 8 paths lo·hi, hi·lo, hi·hi
    added in turn into one accumulator; the fragments into f32 running
    sums, flushed into the block's partial every ``chunk`` nodes and at the
    last; the blocks' partials summed in block order."""
    m, n, h = h1.shape
    blocks = -(-n // tile)
    pad = blocks * tile - n
    a = torch.nn.functional.pad(h1, (0, 0, 0, pad)).reshape(
        m, blocks, tile // 8, 8, h).transpose(-1, -2)
    b = torch.nn.functional.pad(dz2, (0, 0, 0, pad)).reshape(
        m, blocks, tile // 8, 8, h)
    ah, bh = tf32(a), tf32(b)
    al, bl = tf32_read(a - ah), tf32_read(b - bh)
    frag = torch.zeros(m, blocks, h, h)
    for k in range(tile // 8):
        for x, y in ((al, bh), (ah, bl), (ah, bh)):
            frag = frag + x[:, :, k] @ y[:, :, k]
    part = torch.zeros(blocks, h, h)
    run = torch.zeros(blocks, h, h)
    for node in range(m):
        run = run + frag[node]
        if (node + 1) % chunk == 0 or node + 1 == m:
            part, run = part + run, torch.zeros(blocks, h, h)
    total = part[0]
    for blk in range(1, blocks):
        total = total + part[blk]
    return total


@functools.lru_cache(maxsize=None)
def case(h: int):
    """The sweep's inputs at hidden ``h`` (f32), the cotangent, and the
    float64 reference (out, gradients)."""
    rng = np.random.default_rng(h)
    head = {"W": [torch.tensor(rng.standard_normal(s) * math.sqrt(1.0 / s[0]),
                               dtype=torch.float32)
                  for s in ((3, h), (h, h), (h, 1))],
            "b": [torch.tensor(0.1 * rng.standard_normal(n),
                               dtype=torch.float32) for n in (h, h, 1)]}
    nodes, weights = make_merton_default().jump_quadrature(CompensatorSpec())
    a, c, v, _ = rank1_three_feature(head, torch.tensor(25.0), nodes, False,
                                     weights)
    x = torch.tensor(np.exp(0.3 * rng.standard_normal(BATCH)),
                     dtype=torch.float32)
    g = torch.tensor(rng.standard_normal(BATCH) / BATCH, dtype=torch.float32)
    args = tuple(t.detach().contiguous()
                 for t in (x, a, c, head["W"][1], head["b"][1], v))
    leaves = [t.double().requires_grad_(True) for t in args]
    out = sweep_plain(*leaves)
    grads = torch.autograd.grad(out, leaves, g.double())
    return args, g, out.detach(), grads


def distances(mm, h: int):
    """(out's max error relative to max |out|, each leaf's relative
    error, the global-norm relative error) of the emulation against
    float64."""
    args, g, out64, grads64 = case(h)
    out, grads = sweep_emulated(mm, *args, g)
    fwd = float((out.double() - out64).abs().max() / out64.abs().max())
    leaf = {n: float((k.double() - p).norm() / p.norm())
            for n, k, p in zip(LEAVES, grads, grads64)}
    num = math.sqrt(sum(float(((k.double() - p) ** 2).sum())
                        for k, p in zip(grads, grads64)))
    den = math.sqrt(sum(float((p ** 2).sum()) for p in grads64))
    return fwd, leaf, num / den


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_tf32_rounds_to_nearest_at_ten_bits():
    one = 1.0 + 2.0 ** -10
    x = torch.tensor([1.0, 1.0 + 2.0 ** -12, 1.0 + 2.0 ** -11, one,
                      -(1.0 + 2.0 ** -11)], dtype=torch.float32)
    assert tf32(x).tolist() == [1.0, 1.0, one, one, -one]
    assert (tf32(x).view(torch.int32) & 0x1FFF).eq(0).all()
    assert tf32_read(x).tolist() == [1.0, 1.0, 1.0, one, -1.0]
    # hi + lo, lo read as TF32, keeps ~21 bits: within 2^-21 of x, relative
    y = torch.tensor(np.random.default_rng(0).standard_normal(10000),
                     dtype=torch.float32)
    hi = tf32(y)
    lo = tf32_read(y - hi)
    assert float(((hi + lo - y).abs() / y.abs()).max()) <= 2.0 ** -21


@pytest.mark.parametrize("h", [20, 64, 128])
def test_split_tf32_holds_the_chip_tolerances(h):
    fwd, leaf, rel = distances(mm_split, h)
    assert fwd <= FWD_TOL, fwd
    assert rel <= GRAD_TOL, rel
    assert max(leaf.values()) <= GRAD_TOL, leaf


@pytest.mark.parametrize("h", [20, 64, 128])
def test_one_tf32_pass_misses_them(h):
    fwd, leaf, rel = distances(mm_one, h)
    assert fwd > FWD_TOL or max(leaf.values()) > GRAD_TOL, (fwd, leaf)


@pytest.mark.parametrize("h", [20, 64, 128])
def test_b4w_dw1_summation_order_holds_float64(h):
    """dW1 in split TF32, summed in B4w's order, stays within the chip's
    1e-4 relative of float64, as the one-matmul emulation does."""
    args, g, _, grads64 = case(h)
    x, a, c, w1, b1, v = args
    h1 = torch.tanh(x[None, :, None] * a[:, None, :] + c[:, None, :])
    h2 = torch.tanh(mm_split(h1, w1) + b1)
    dz2 = (g[None, :, None] * v[:, None, :]) * (1.0 - h2 * h2)
    ref = grads64[LEAVES.index("W1")]
    ordered = float((dw1_b4w_order(h1, dz2).double() - ref).norm()
                    / ref.norm())
    _, leaf, _ = distances(mm_split, h)
    assert ordered <= GRAD_TOL, ordered
    assert ordered <= 10 * max(leaf["W1"], 1e-7), (ordered, leaf["W1"])
