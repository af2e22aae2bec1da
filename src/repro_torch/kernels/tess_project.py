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

__all__ = ["TESS_MAX_K", "TESS_THREAD_MAX_K", "TESS_WARP_MAX_K",
           "tess_project", "tess_project_plain"]

#: widest row of the one-thread-per-row route (the row's keys in registers)
TESS_THREAD_MAX_K = 32
#: widest row of the one-warp-per-row route; wider rows take one CTA a row
TESS_WARP_MAX_K = 1024
#: widest row the card takes: the CTA route's k keys and k running sums
#: (12k bytes) must fit in a block's 232,448 bytes of shared memory
TESS_MAX_K = 19200

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]


def tess_project_plain(z: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """z: (B, k) f32 -> (pattern int8 (B, k), a f32 (B, k))."""
    pat = ternary_pattern(z)
    t = pat.abs().sum(dim=-1, keepdim=True).to(torch.float32)
    return pat, pat.to(torch.float32) / torch.sqrt(torch.clamp(t, min=1))


def tess_project(z: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel: z (B, k) f32 contiguous on the card.  The
    route follows k: a thread a row up to ``TESS_THREAD_MAX_K``, a warp a row
    up to ``TESS_WARP_MAX_K``, a CTA a row up to ``TESS_MAX_K``."""
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
    fn = _build.entry("tess_project", "tess_project_f32", _ARGTYPES)
    _build.check(_build.launch(fn, z.device, z.data_ptr(), pat.data_ptr(),
                               a.data_ptr(), b, k), "tess_project")
    tess_project.launches += 1
    return pat, a


tess_project.launches = 0
