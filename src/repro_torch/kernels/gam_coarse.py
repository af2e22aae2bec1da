"""Coarse GAM LM-head scores against int8 ternary patterns.

``gam_coarse`` launches the CUDA kernel ``csrc/gam_coarse.cu`` on CUDA
tensors; ``gam_coarse_plain`` is its plain PyTorch version (CPU tensors, and
the kernel's reference), the formula of the reference's ``gam_coarse_ref``:
``(h @ patterns) * inv_sqrt_nnz`` in f32.  Counterpart of the Pallas kernel
in ``repro.kernels.gam_coarse``.  No model path of either package calls it:
the GAM head scores through the posting table.

The kernel sums over d in one sequential f32 fma loop; the plain version's
matrix product sums in another order, so the two agree within the rounding
bound of a d-term f32 sum (see :func:`coarse_tolerance`), not bit for bit.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

__all__ = ["coarse_tolerance", "gam_coarse", "gam_coarse_plain"]


def gam_coarse_plain(h: torch.Tensor, patterns: torch.Tensor,
                     inv_sqrt_nnz: torch.Tensor) -> torch.Tensor:
    """h (B, d), patterns (d, V) int8, inv_sqrt_nnz (V,) -> (B, V) f32."""
    return (h.float() @ patterns.float()) * inv_sqrt_nnz[None, :]


def coarse_tolerance(h: torch.Tensor, patterns: torch.Tensor,
                     inv_sqrt_nnz: torch.Tensor) -> torch.Tensor:
    """(B, V) bound on |kernel - plain|: each of the two sums of d f32 terms
    lies within d * 2^-24 * sum|h p| of the exact sum, whatever its order
    (the first-order bound of recursive summation), so the two differ by at
    most twice that, scaled like the output, plus the final rounding."""
    d = h.shape[-1]
    mag = (h.float().abs() @ patterns.float().abs()) * inv_sqrt_nnz.abs()
    return (2 * d + 2) * 2.0 ** -24 * mag


def gam_coarse(h: torch.Tensor, patterns: torch.Tensor,
               inv_sqrt_nnz: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel: h (B, d) f32, patterns (d, V) int8,
    inv_sqrt_nnz (V,) f32, contiguous on one card -> (B, V) f32."""
    dev = h.device
    for name, t in (("h", h), ("patterns", patterns),
                    ("inv_sqrt_nnz", inv_sqrt_nnz)):
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"gam_coarse kernel needs CUDA tensors on one "
                             f"device, {name} is on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"gam_coarse: {name} must be contiguous")
    if (h.dtype != torch.float32 or patterns.dtype != torch.int8
            or inv_sqrt_nnz.dtype != torch.float32):
        raise ValueError(f"gam_coarse takes f32 h, int8 patterns and f32 "
                         f"inv_sqrt_nnz, got {h.dtype}, {patterns.dtype}, "
                         f"{inv_sqrt_nnz.dtype}")
    if h.dim() != 2 or patterns.dim() != 2 or inv_sqrt_nnz.dim() != 1:
        raise ValueError(f"gam_coarse shapes h {tuple(h.shape)}, patterns "
                         f"{tuple(patterns.shape)}, inv_sqrt_nnz "
                         f"{tuple(inv_sqrt_nnz.shape)}")
    b, d = h.shape
    v = patterns.shape[1]
    if patterns.shape[0] != d or inv_sqrt_nnz.shape[0] != v or min(
            b, d, v) < 1:
        raise ValueError(f"gam_coarse shapes h {tuple(h.shape)}, patterns "
                         f"{tuple(patterns.shape)}, inv_sqrt_nnz "
                         f"{tuple(inv_sqrt_nnz.shape)} do not match")
    if b > 8 * 65535 or d >= 1 << 31:
        raise ValueError(f"gam_coarse takes B <= {8 * 65535} and d < 2^31, "
                         f"got {(b, d)}")
    out = torch.empty((b, v), dtype=torch.float32, device=dev)
    fn = _build.library("gam_coarse").gam_coarse_f32
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int,
                                           ctypes.c_int64, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.check(fn(h.data_ptr(), patterns.data_ptr(),
                        inv_sqrt_nnz.data_ptr(), out.data_ptr(), b, d, v,
                        stream), "gam_coarse")
    gam_coarse.launches += 1
    return out


gam_coarse.launches = 0
