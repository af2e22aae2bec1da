"""Causal GQA flash attention for prefill.

``flash_prefill`` launches the CUDA kernel ``csrc/flash_prefill.cu`` on CUDA
tensors; ``flash_prefill_plain`` is its plain PyTorch version (CPU tensors,
and the kernel's reference), the formula of the reference's
``flash_prefill_ref``: causal scores and softmax in f32, the output rounded
once to q's dtype.  Counterpart of the Pallas kernel in
``repro.kernels.flash_prefill``.  bf16 runs on the tensor cores (p split
exactly into three bf16 terms for p.v), f32 on the CUDA cores.  No model
path of either package calls it: the prefill attends with the blockwise
einsum path.

Layout: q (B, S, Hkv, G, hd), G = H / Hkv query heads per KV head; k/v
(B, S, Hkv, hd); out like q.  The kernel takes hd <= 128 and G <= 128.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

__all__ = ["FLASH_MAX_G", "FLASH_MAX_HD", "NEG", "flash_prefill",
           "flash_prefill_plain", "query_tile"]

NEG = -1e30
_ROWS = 128          # (position, head) rows of a CTA (FP_ROWS)
#: widest head the kernels take (the accumulators of a thread's rows are
#: held in registers)
FLASH_MAX_HD = 128
#: most query heads per KV head (one position's heads fill at most a CTA)
FLASH_MAX_G = _ROWS


def flash_prefill_plain(q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor) -> torch.Tensor:
    """q (B, S, Hkv, G, hd); k/v (B, S, Hkv, hd) -> causal attention, shaped
    and typed like q."""
    hd = q.shape[-1]
    s = torch.einsum("bqkgd,bskd->bqkgs", q.float(), k.float()) * hd ** -0.5
    sq = q.shape[1]
    mask = torch.tril(torch.ones((sq, sq), dtype=torch.bool, device=q.device))
    s = torch.where(mask[None, :, None, None, :], s, NEG)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqkgs,bskd->bqkgd", p, v.float()).to(q.dtype)


def query_tile(g: int) -> int:
    """Query positions per CTA: as many whole positions (all G heads each)
    as fill the kernel's 128 rows."""
    return max(1, _ROWS // g)


def flash_prefill(q: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on contiguous f32 or bf16 tensors on one card."""
    dev = q.device
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"flash_prefill kernel needs CUDA tensors on one "
                             f"device, {name} is on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"flash_prefill: {name} must be contiguous")
    if q.dtype not in (torch.float32, torch.bfloat16) or not (
            k.dtype == v.dtype == q.dtype):
        raise ValueError(f"flash_prefill takes f32 or bf16 q/k/v of one "
                         f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 5 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_prefill shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    b, s, hkv, g, hd = q.shape
    if tuple(k.shape) != (b, s, hkv, hd):
        raise ValueError(f"flash_prefill: k {tuple(k.shape)} does not match "
                         f"q {tuple(q.shape)}")
    if not (1 <= hd <= FLASH_MAX_HD and 1 <= g <= FLASH_MAX_G) or min(
            b, s, hkv) < 1:
        raise ValueError(f"flash_prefill takes 1 <= hd <= {FLASH_MAX_HD}, "
                         f"1 <= G <= {FLASH_MAX_G} and non-empty B, S, Hkv, "
                         f"got {tuple(q.shape)}")
    if b > 65535 or hkv > 65535 or q.numel() >= 1 << 62:
        raise ValueError(f"flash_prefill: grid (Hkv {hkv}, B {b}) exceeds "
                         f"65535")
    out = torch.empty_like(q)
    lib = _build.library("flash_prefill")
    fn = (lib.flash_prefill_f32 if q.dtype == torch.float32
          else lib.flash_prefill_bf16)
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr(), b, s, hkv, g, hd, query_tile(g),
                        hd ** -0.5, stream), "flash_prefill")
    flash_prefill.launches += 1
    return out


flash_prefill.launches = 0
