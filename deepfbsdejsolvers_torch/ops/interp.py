"""Interpolation on uniform grids, on the device.

The Variance-Gamma price curves (the Carr-Madan FFT curve, the Gil-Pelaez
exercise probabilities) are tabulated per step on a uniform log-moneyness
grid, so a query finds its cell by arithmetic, with no search.  The cubic is
the Catmull-Rom stencil [i−1, i, i+1, i+2], clamped at the table's ends.

A table is one curve (n,), or one curve per row (R, n) read at the row
index ``row`` (an int or an integer tensor broadcasting against the
queries), so the per-step tables of a model serve a batch of steps in one
gather.
"""

from __future__ import annotations

import torch


def _cell(x, x0, dx, n):
    """(cell index, fraction in the cell) of x on the grid x0 + k·dx; the
    index clamped to the cells [0, n − 2]."""
    pos = (x - x0) / dx
    idx = torch.clamp(torch.floor(pos), 0, n - 2).long()
    frac = pos - idx.to(pos.dtype)
    return idx, frac


def _reader(table, row):
    """``read(k)``: the entries k of the curve (or of row ``row``)."""
    if table.ndim == 1:
        return lambda k: table[k]
    row = torch.as_tensor(row, device=table.device).long()
    return lambda k: table[row, k]


def uniform_interp_linear(table, x, x0, dx, row=None):
    """Linear interpolation of ``table`` sampled at x0 + k·dx, at x."""
    n = table.shape[-1]
    idx, t = _cell(x, x0, dx, n)
    read = _reader(table, row)
    y0 = read(idx)
    return y0 + t * (read(idx + 1) - y0)


def uniform_interp_cubic(table, x, x0, dx, row=None):
    """Catmull-Rom cubic interpolation of ``table`` sampled at x0 + k·dx,
    at x, with the stencil's ends clamped to the table."""
    n = table.shape[-1]
    idx, t = _cell(x, x0, dx, n)
    read = _reader(table, row)
    p0 = read(torch.clamp(idx - 1, 0, n - 1))
    p1 = read(idx)
    p2 = read(torch.clamp(idx + 1, 0, n - 1))
    p3 = read(torch.clamp(idx + 2, 0, n - 1))
    t2 = t * t
    t3 = t2 * t
    return 0.5 * ((2.0 * p1)
                  + (-p0 + p2) * t
                  + (2.0 * p0 - 5.0 * p1 + 4.0 * p2 - p3) * t2
                  + (-p0 + 3.0 * p1 - 3.0 * p2 + p3) * t3)
