"""Int8 factor quantization with per-block scales, on torch tensors.

Counterpart of ``repro.compress.quantize``.  One f32 scale per block of
``block`` rows (the fused kernel's item block, so the kernel reads one scale
per block it scores): ``s = max|x| / 127``, ``q = round_half_even(x / s)``
clipped to [-127, 127]; an all-zero block gets scale 1.0.  The slab and the
scales are byte-identical to the reference's on any device:

* both divisions take a tensor divisor (127s, and the broadcast per-block
  scales).  PyTorch's CUDA division by a CPU *scalar* multiplies by its
  reciprocal, which can be one ulp off the true quotient numpy gives;
* ``torch.round`` rounds half to even, as ``np.rint`` does.

Every dequantized element is within ``s/2`` of its original, so a dot
product against ``u`` is off by at most ``(s/2) * sum|u|``
(:func:`score_error_bound`); the serving path re-ranks its pool against the
exact f32 rows and uses the bound only to size ``rerank_factor``.
"""
from __future__ import annotations

import torch

__all__ = ["dequantize_int8", "quantization_error_bound", "quantize_int8",
           "score_error_bound"]


def quantize_int8(x, block: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(n, k) f32, n a multiple of ``block`` -> ((n, k) int8, (n // block,)
    f32 scales), on ``x``'s device."""
    x = torch.as_tensor(x, dtype=torch.float32).contiguous()
    n, k = x.shape
    block = int(block)
    if block < 1 or n % block:
        raise ValueError(f"rows {n} not a multiple of block {block}")
    nb = n // block
    if n == 0:
        return (torch.zeros((0, k), dtype=torch.int8, device=x.device),
                torch.zeros(0, dtype=torch.float32, device=x.device))
    amax = x.abs().reshape(nb, block * k).amax(dim=1)
    scales = torch.where(amax > 0, amax / torch.full_like(amax, 127.0),
                         torch.ones_like(amax))
    q = torch.round(x.reshape(nb, block, k) / scales[:, None, None])
    q = q.clamp(-127, 127).to(torch.int8)
    return q.reshape(n, k), scales


def dequantize_int8(q, scales, block: int) -> torch.Tensor:
    """(n, k) int8 + per-block scales -> (n, k) f32: the one f32 multiply
    the kernel does per element."""
    q = torch.as_tensor(q, dtype=torch.int8)
    n, k = q.shape
    s = torch.as_tensor(scales, dtype=torch.float32,
                        device=q.device).reshape(-1)
    nb = n // int(block)
    return (q.float().reshape(nb, int(block), k) * s[:, None, None]).reshape(
        n, k)


def quantization_error_bound(scales) -> torch.Tensor:
    """Per-block bound on |x - dequant(quant(x))| per element: half a step."""
    return torch.as_tensor(scales, dtype=torch.float32) * 0.5


def score_error_bound(scales, users) -> torch.Tensor:
    """(Q, n_blocks) bound on the dot-product error of any item in a block
    against each query: ``(scale/2) * sum|u|``."""
    bound = quantization_error_bound(scales).reshape(-1)
    u1 = torch.as_tensor(users, dtype=torch.float32,
                         device=bound.device).abs().sum(dim=-1)
    return u1[:, None] * bound[None, :]
