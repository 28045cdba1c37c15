"""The yardstick's arithmetic: operations and bytes of each kernel's
function, the forward operations of a network evaluation, and the card's
published peaks.

The kernel counts are a frozen copy of ``chip_smoke.py``'s ``work()``,
except that a backward counts the adjoint's own work: ``work()`` charges
B2 and B4 for the forward they recompute (B2 the Γ head's layers and the
three table values, B4 the sweep's hidden layers), an implementation
choice that a backward storing its activations would not make.  Each
input is read once and each output written once; each tanh counts as one
operation.
"""

from __future__ import annotations

# NVIDIA H100 SXM, data sheet, dense rates at the full 700 W power limit:
# FP32 outside the tensor cores, and HBM3 bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# Chebyshev coefficients per piece of the hoisted tables (degree 7).
TABLE_COEFFS = 8


def rollout_fwd(n: int, batch: int, h: int, p: int):
    """(FLOPs, bytes) of the hoisted rollout's forward (kernel B1's
    function) over ``n`` steps of ``batch`` paths, a head of width ``h`` and
    tables of ``p`` pieces.  Per path-step: the head 2H² + 10H and its 2H
    tanh, three degree-7 Clenshaw evaluations of 24 FLOPs, ~40 FLOPs of
    piece lookup, BSDE and walk update; dW and J read, the x and y
    residuals written, x_N and y_N written, the three tables read."""
    ps = n * batch
    flops = ps * (2 * h * h + 12 * h + 3 * 24 + 40)
    nbytes = 16 * ps + 8 * batch + 3 * n * p * TABLE_COEFFS * 4
    return flops, nbytes


def rollout_bwd(n: int, batch: int, h: int, p: int):
    """(FLOPs, bytes) of the rollout's adjoint (kernel B2's function, less
    the forward it recomputes).  Per path-step: the head's backward 2H² +
    4H, the parameter sums 2H² + 12H, the three tables' derivatives (24
    each) and coefficient sums (3·8·2), ~50 FLOPs of the reverse
    recurrence; the residuals, dW and J read, the x_N and y_N cotangents
    read, the tables read and their cotangents written."""
    ps = n * batch
    flops = ps * (4 * h * h + 16 * h + 3 * 24 + 48 + 50)
    nbytes = 16 * ps + 8 * batch + 2 * 3 * n * p * TABLE_COEFFS * 4
    return flops, nbytes


def sweep_fwd(m: int, batch: int, h: int):
    """(FLOPs, bytes) of one compensator sweep's forward (kernel B3's
    function) over ``m`` nodes and ``batch`` paths.  Per path-node: x·a + c
    (2H), tanh (H), the H×H layer with bias (2H² + H), tanh (H), the
    v-weighted sum (2H); x read, the sum written, the node rows (a, c, v)
    and the H×H layer read once."""
    flops = m * batch * (2 * h * h + 7 * h)
    nbytes = 8 * batch + 12 * m * h + 4 * (h * h + h)
    return flops, nbytes


def sweep_bwd(m: int, batch: int, h: int):
    """(FLOPs, bytes) of one sweep's backward (kernel B4's function, less
    the hidden layers it recomputes).  Per path-node: g·h2 (H), dz2 (4H),
    W1·dz2 (2H²), dz1 (3H), dx (2H), and the sums over paths: dW1 (2H²),
    db1, dc, dv (H each), da (2H); x and g read, dx written, the node rows
    and weights read and their cotangents written."""
    flops = m * batch * (4 * h * h + 15 * h)
    nbytes = 12 * batch + 24 * m * h + 8 * (h * h + h)
    return flops, nbytes


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the operations at
    the FP32 peak and the bytes at the HBM rate, in seconds."""
    return max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES)


def mlp_forward_flops(n_in: int, hidden, n_out: int) -> int:
    """Forward operations of one evaluation of a tanh MLP n_in → hidden… →
    n_out: 2·fan_in·fan_out + fan_out a layer (product, sum, bias), one a
    tanh."""
    sizes = (n_in, *hidden, n_out)
    flops = 0
    for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
        flops += 2 * a * b + b
        if i < len(sizes) - 2:
            flops += b
    return flops


def step_network_flops(wl: dict, cfg: dict, batch: int,
                       n_nodes: int) -> float:
    """Forward operations of every network evaluation one training step's
    loss needs, from the configuration's widths: the Γ net at each
    path-step's realized jump; the compensator's Γ over the ``n_nodes``
    jump nodes at each path-step (per step) or at each table point (hoisted
    tables); and in the jump-diffusion regime the Z net at each path-step
    or table point."""
    solver = wl["solver"]
    hidden = tuple(int(h) for h in cfg["hidden"])
    n = int(cfg["N"])
    f_gam = mlp_forward_flops(3, hidden, 1)
    f_z = mlp_forward_flops(2, hidden, 1) if "sigma" in cfg else 0
    flops = batch * n * f_gam
    if solver.get("hoist"):
        points = int(solver["pw_pieces"]) * (int(solver["pw_degree"]) + 1)
        flops += n * points * (n_nodes * f_gam + f_z)
    else:
        flops += batch * n * (n_nodes * f_gam + f_z)
    return float(flops)
