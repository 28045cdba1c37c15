"""The Merton model's icdf jump sum: plain PyTorch and one CUDA kernel.

With uniform draws u and normal draws z of one shape, and the Poisson CDF
table of λ·dt (``models/merton.py``), the jump sum over one dt is

    dN = #{k : u > cdf[k]},   J = dN·μJ + σJ·sqrt(dN)·z.

``icdf_jumps_plain`` is that expression as eager PyTorch writes it: on a
card a chain of kernels over the array, with (…, K) bool and int64
transients.  ``icdf_jumps`` checks its inputs, then runs the plain version
on CPU tensors and the kernel ``csrc/icdf_jumps.cu`` on CUDA tensors (one
pass, 12 bytes an element, bit for bit the plain version's J); it counts
the kernel's launches in ``icdf_jumps.launches`` and has no fallback from
the kernel to the plain version.  The draws stay with the caller, so the
generator is consumed as before.
"""

from __future__ import annotations

import ctypes

import torch

# The longest CDF table the kernel takes in its arguments (csrc/icdf_jumps.cu).
MAX_TABLE = 512


def icdf_jumps_plain(u: torch.Tensor, z: torch.Tensor, cdf: torch.Tensor,
                     mu_j: float, sig_j: float) -> torch.Tensor:
    """J from u, z and ``cdf`` on u's device, in eager PyTorch."""
    dn = (u[..., None] > cdf).sum(-1).to(torch.float32)
    return dn * mu_j + sig_j * torch.sqrt(dn) * z


def _check(u, z, cdf) -> None:
    for name, t in (("u", u), ("z", z)):
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: dtype {t.dtype}, expected "
                             "torch.float32")
        if not t.is_contiguous():
            raise ValueError(f"{name}: must be contiguous")
    if z.shape != u.shape or z.device != u.device:
        raise ValueError(f"z: {tuple(z.shape)} on {z.device}, expected u's "
                         f"{tuple(u.shape)} on {u.device}")
    if (cdf.dtype != torch.float32 or cdf.ndim != 1
            or not 1 <= cdf.shape[0] <= MAX_TABLE
            or cdf.device.type != "cpu" or not cdf.is_contiguous()):
        raise ValueError(f"cdf: expected a contiguous float32 (K,) CPU "
                         f"tensor with 1 <= K <= {MAX_TABLE}, got "
                         f"{cdf.dtype} {tuple(cdf.shape)} on {cdf.device}")


def _kernel():
    """The kernel library's C entry with its argument types declared."""
    from deepfbsdejsolvers_torch.ops import _build

    fn = _build.load("icdf_jumps").icdf_jumps
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int]
                   + [ctypes.c_float] * 2 + [ctypes.c_void_p])
    return fn


def icdf_jumps(u: torch.Tensor, z: torch.Tensor, cdf: torch.Tensor,
               mu_j: float, sig_j: float) -> torch.Tensor:
    """J from contiguous float32 u, z of one shape and the CDF table ``cdf``,
    a float32 (K,) CPU tensor: the plain version on CPU tensors, the kernel
    on CUDA tensors (μJ and σJ rounded to float32, as eager rounds a Python
    scalar for a float32 kernel)."""
    _check(u, z, cdf)
    if u.device.type == "cpu":
        return icdf_jumps_plain(u, z, cdf, mu_j, sig_j)
    if u.device.type != "cuda":
        raise ValueError(f"u: on {u.device}, expected a CPU or CUDA tensor")
    j = torch.empty_like(u)
    if u.numel() == 0:
        return j
    fn = _kernel()
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        rc = fn(u.data_ptr(), z.data_ptr(), cdf.data_ptr(), j.data_ptr(),
                u.numel(), cdf.shape[0], mu_j, sig_j, stream)
    if rc != 0:
        raise RuntimeError(f"icdf_jumps: CUDA error {rc} at launch")
    icdf_jumps.launches += 1
    return j


icdf_jumps.launches = 0
