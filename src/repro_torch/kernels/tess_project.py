"""Batched ternary tessellation projection (Algorithm 2): the map step.

``tess_project`` launches the CUDA kernel ``csrc/tess_project.cu`` on a CUDA
tensor; ``tess_project_plain`` is its plain PyTorch version, used for CPU
tensors and as the kernel's reference.  Counterpart of the Pallas kernel in
``repro.kernels.tess_project``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.tessellation import ternary_pattern
from repro_torch.kernels import _build

__all__ = ["TESS_MAX_K", "TESS_THREAD_MAX_K", "tess_project",
           "tess_project_plain"]

#: widest row of the one-thread-per-row kernel (its per-thread row buffers);
#: wider rows take the one-CTA-per-row kernel
TESS_THREAD_MAX_K = 256
#: widest row the card takes: the wide kernel's three k-long arrays (12k
#: bytes) and its 2 KB reduction must fit in 227 KB of shared memory
TESS_MAX_K = 19200


def tess_project_plain(z: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """z: (B, k) f32 -> (pattern int8 (B, k), a f32 (B, k))."""
    pat = ternary_pattern(z)
    t = pat.abs().sum(dim=-1, keepdim=True).to(torch.float32)
    return pat, pat.to(torch.float32) / torch.sqrt(torch.clamp(t, min=1))


def tess_project(z: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel: z (B, k) f32 contiguous on the card; rows
    wider than ``TESS_THREAD_MAX_K`` take the one-CTA-per-row kernel."""
    if z.device.type != "cuda":
        raise ValueError(f"tess_project kernel needs a CUDA tensor, got {z.device}")
    if z.dtype != torch.float32 or z.dim() != 2 or not z.is_contiguous():
        raise ValueError(f"tess_project takes a contiguous (B, k) float32 "
                         f"tensor, got {tuple(z.shape)} {z.dtype}")
    b, k = z.shape
    if not 1 <= k <= TESS_MAX_K:
        raise ValueError(
            f"tess_project supports 1 <= k <= {TESS_MAX_K}, got {k}: a row "
            f"needs 12k = {12 * k} bytes of shared memory and the card "
            f"gives a block at most 232,448 (rows are not streamed)")
    pat = torch.empty((b, k), dtype=torch.int8, device=z.device)
    a = torch.empty((b, k), dtype=torch.float32, device=z.device)
    lib = _build.library("tess_project")
    fn = lib.tess_project_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(z.device):
        stream = torch.cuda.current_stream(z.device).cuda_stream
        _build.check(fn(z.data_ptr(), pat.data_ptr(), a.data_ptr(), b, k,
                        stream), "tess_project")
    tess_project.launches += 1
    return pat, a


tess_project.launches = 0
