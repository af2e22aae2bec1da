"""Dense masked MIPS scoring, the oracle of the fused retrieval kernel.

``gam_score`` launches ``csrc/gam_score.cu`` on CUDA tensors;
``gam_score_plain`` is its plain PyTorch version (CPU tensors, and the
kernel's reference).  Both compute ``where(mask, u @ v.T, NEG)`` with the
same arithmetic as the fused kernel: a fixed-order loop of f32 fused
multiply-adds over k, which is also what the reference's dot computes.
Counterpart of ``repro.kernels.gam_score``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

__all__ = ["NEG", "dot_plain", "fma_dot", "gam_score", "gam_score_plain"]

NEG = -1e30

# queries a call: the grid's y extent (65,535) of query chunks, 256 queries
# a chunk where item rows sit in registers (k <= 32), 8 where k is staged
_MAX_Q_REGISTERS = 65535 * 256
_MAX_Q_STAGED = 65535 * 8
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int64,
                                     ctypes.c_int, ctypes.c_void_p]


def fma_dot(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(..., k) x (..., k), broadcast -> (...) f32: a fused multiply-add per
    step over k, in order from 0, as the kernels compute it.

    torch has no f32 fma, so each step is taken in f64, where the product of
    two f32 values is exact, and rounded back to f32.  That double rounding
    can differ from a true fma by one ulp, in about one step of 2^29."""
    u = u.to(torch.float64)
    v = v.to(torch.float64)
    shape = torch.broadcast_shapes(u.shape[:-1], v.shape[:-1])
    out = torch.zeros(shape, dtype=torch.float32, device=u.device)
    for d in range(u.shape[-1]):
        out = (out.to(torch.float64) + u[..., d] * v[..., d]).to(
            torch.float32)
    return out


def dot_plain(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(Q, k) x (N, k) -> (Q, N) f32 by :func:`fma_dot`."""
    return fma_dot(u[:, None, :], v[None, :, :])


def gam_score_plain(u: torch.Tensor, v: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
    """u: (Q, k), v: (N, k), mask: (Q, N) -> masked scores (Q, N) f32."""
    return torch.where(mask != 0, dot_plain(u, v), NEG)


def gam_score(u: torch.Tensor, v: torch.Tensor,
              mask: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on f32 or bf16 factors and a (Q, N) mask."""
    for name, t in (("u", u), ("v", v), ("mask", mask)):
        if t.device.type != "cuda" or t.device != u.device:
            raise ValueError(f"gam_score kernel needs CUDA tensors on one "
                             f"device, {name} is on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"gam_score: {name} must be contiguous")
    if u.dtype not in (torch.float32, torch.bfloat16) or v.dtype != u.dtype:
        raise ValueError(f"gam_score takes f32 or bf16 factors of one dtype, "
                         f"got {u.dtype} and {v.dtype}")
    if mask.dtype not in (torch.bool, torch.int8):
        raise ValueError(f"gam_score mask must be bool or int8, got {mask.dtype}")
    q, k = u.shape
    n = v.shape[0]
    if v.shape[1] != k or tuple(mask.shape) != (q, n):
        raise ValueError(f"gam_score shapes u {tuple(u.shape)}, v "
                         f"{tuple(v.shape)}, mask {tuple(mask.shape)}")
    max_q = _MAX_Q_REGISTERS if k <= 32 else _MAX_Q_STAGED
    if q > max_q:
        raise ValueError(f"gam_score takes at most {max_q} queries a call at "
                         f"k = {k} (its grid's y extent), got {q}")
    out = torch.empty((q, n), dtype=torch.float32, device=u.device)
    fn = _build.entry("gam_score", "gam_score_f32" if u.dtype == torch.float32
                      else "gam_score_bf16", _ARGTYPES)
    _build.check(_build.launch(fn, u.device, u.data_ptr(), v.data_ptr(),
                               mask.data_ptr(), out.data_ptr(), q, n, k),
                 "gam_score")
    gam_score.launches += 1
    return out


gam_score.launches = 0
