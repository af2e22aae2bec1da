"""One-token GQA attention over a KV cache (flash-decode).

``decode_attention`` launches the CUDA kernel ``csrc/decode_attention.cu``
on CUDA tensors; ``decode_attention_plain`` is its plain PyTorch version
(CPU tensors, and the kernel's reference), the formula of the reference's
``decode_attention_ref``: scores and softmax in f32 over the positions
``<= length``, the output rounded once to q's dtype.  Counterpart of the
Pallas kernel in ``repro.kernels.decode_attention``.  bf16 runs on the
tensor cores (p split exactly into three bf16 terms for p.v), f32 on the
CUDA cores.

Layout: q (B, Hkv, G, hd), G = H / Hkv query heads per KV head; k/v
(B, S, Hkv, hd); out (B, Hkv, G, hd).  ``length`` is a () int32 tensor on
the card (or a Python int); the kernel reads it from device memory.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

__all__ = ["NEG", "decode_attention", "decode_attention_plain",
           "decode_splits"]

NEG = -1e30
# the f32 kernel (decode_partial_kernel)
_THREADS = 128          # threads of a CTA (DA_THREADS)
_MAX_PAIRS = 128 * 16   # (query head, dim) accumulators of one CTA
_MAX_HEADS_PER_CTA = 32
_CTAS_PER_SM = 16       # splits are sized to give about this many CTAs
_TILE_SMEM = 100 * 1024  # largest shared memory a tile size may take
# the bf16 kernel (decode_mma_kernel)
_MMA_HEADS = 16         # query heads of a CTA, one mma row tile (DM_HEADS)
_MMA_WARPS = 4          # warps of a CTA, each with its own ring (DM_WARPS)
_MMA_STAGES = 3         # tiles in a warp's ring (DM_STAGES)
_MMA_CTAS_PER_SM = 1    # splits are sized to give about this many CTAs


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           length) -> torch.Tensor:
    """q (B, Hkv, G, hd); k/v (B, S, Hkv, hd); attends to positions <=
    ``length``.  Returns (B, Hkv, G, hd) in q.dtype."""
    hd = q.shape[-1]
    s = torch.einsum("bkgd,bskd->bkgs", q.float(), k.float()) * hd ** -0.5
    pos = torch.arange(k.shape[1], device=k.device)
    length = torch.as_tensor(length, device=k.device)
    s = torch.where(pos[None, None, None, :] <= length, s, NEG)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bkgs,bskd->bkgd", p, v.float()).to(q.dtype)


def _gc(g: int) -> int:
    """Query heads per score chunk: the smallest power of two >= min(G, 8)."""
    gc = 1
    while gc < min(g, 8):
        gc *= 2
    return gc


def _smem(tile: int, gpad: int, hd: int, elt: int) -> int:
    """Shared memory of the kernel (decode_smem in the source), bytes: two
    stages of K and V tiles with 16-byte padded rows, the query rows, the
    scores and (m, l, correction)."""
    hd4 = -(-hd // 4) * 4
    return (4 * tile * (hd * elt + 16)
            + 4 * (gpad * hd4 + gpad * tile + 3 * gpad))


def _mma_hdp(hd: int) -> int:
    """The bf16 kernel's padded head width (its HDP template): 32..256."""
    return next(w for w in (32, 64, 128, 256) if hd <= w)


def _mma_tile(hd: int) -> int:
    """Positions of one warp's tile in the bf16 kernel (DmShape::T)."""
    return 16 if _mma_hdp(hd) >= 128 else 32


def _mma_smem(hd: int) -> int:
    """Shared memory of the bf16 kernel (DmShape::BYTES), bytes: each warp's
    ring of K and V tiles with 16-byte padded rows, and the query rows."""
    ld = _mma_hdp(hd) + 8
    return 2 * (_MMA_WARPS * _MMA_STAGES * 2 * _mma_tile(hd) * ld
                + _MMA_HEADS * ld)


def decode_splits(b: int, hkv: int, g: int, hd: int, s: int, sms: int,
                  elt: int = 2) -> tuple[int, int, int, int, int, int]:
    """The kernel's grid: (gc, heads per CTA, head blocks, tile, chunk,
    splits) for ``elt``-byte elements.

    bf16 (``elt`` 2, the tensor-core kernel): 16 query heads a CTA, tiles
    of 32 positions (16 at hd > 64) that its warps take in turn, gc 0 (no
    score chunks).  f32: tiles are 64 positions, or 32 / 16 where two stages
    of K and V rows would take more than 100 KB of shared memory.  S is cut
    into chunks of whole tiles, as many as give about ``_MMA_CTAS_PER_SM`` /
    ``_CTAS_PER_SM`` CTAs per SM (at most one tile per chunk)."""
    if elt == 2:
        n_gblk = -(-g // _MMA_HEADS)
        tile = _mma_tile(hd)
        tiles = -(-s // tile)
        want = -(-_MMA_CTAS_PER_SM * sms // (b * hkv * n_gblk))
        n_split = max(1, min(tiles, want))
        chunk = -(-tiles // n_split) * tile
        return 0, min(g, _MMA_HEADS), n_gblk, tile, chunk, -(-s // chunk)
    gc = _gc(g)
    gblk = min(g, _MAX_HEADS_PER_CTA, _MAX_PAIRS // hd // gc * gc)
    n_gblk = -(-g // gblk)
    gpad = -(-gblk // gc) * gc
    tile = 64
    while tile > 16 and _smem(tile, gpad, hd, elt) > _TILE_SMEM:
        tile //= 2
    # narrower score chunks until each of the 128 / tile thread groups has
    # one (the padded group only shrinks, so the tile still fits)
    while gc > 1 and -(-gblk // gc) < _THREADS // tile:
        gc //= 2
    tiles = -(-s // tile)
    want = -(-_CTAS_PER_SM * sms // (b * hkv * n_gblk))
    n_split = max(1, min(tiles, want))
    chunk = -(-tiles // n_split) * tile
    return gc, gblk, n_gblk, tile, chunk, -(-s // chunk)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     length) -> torch.Tensor:
    """Launch the CUDA kernel on contiguous f32 or bf16 tensors on one card;
    ``length``: () int32 on the card, or an int."""
    dev = q.device
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"decode_attention kernel needs CUDA tensors on "
                             f"one device, {name} is on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"decode_attention: {name} must be contiguous")
    if q.dtype not in (torch.float32, torch.bfloat16) or not (
            k.dtype == v.dtype == q.dtype):
        raise ValueError(f"decode_attention takes f32 or bf16 q/k/v of one "
                         f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"decode_attention shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    b, hkv, g, hd = q.shape
    s = k.shape[1]
    if (k.shape[0], k.shape[2], k.shape[3]) != (b, hkv, hd):
        raise ValueError(f"decode_attention: k {tuple(k.shape)} does not "
                         f"match q {tuple(q.shape)}")
    if not 1 <= hd <= 256 or s < 1 or b < 1 or g < 1:
        raise ValueError(f"decode_attention takes 1 <= hd <= 256 and "
                         f"non-empty B, G, S, got {tuple(q.shape)}, S={s}")
    if b * hkv * g >= 1 << 31 or b * s * hkv * hd >= 1 << 62:
        raise ValueError("decode_attention: tensors too large for the grid")
    if isinstance(length, torch.Tensor):
        if length.device != dev or length.numel() != 1:
            raise ValueError(f"decode_attention: length must be one value on "
                             f"{dev}, got {tuple(length.shape)} on "
                             f"{length.device}")
        length = length.reshape(()).to(torch.int32)
    else:
        length = torch.tensor(int(length), dtype=torch.int32, device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    elt = q.element_size()
    gc, gblk, n_gblk, tile, chunk, n_split = decode_splits(b, hkv, g, hd, s,
                                                           sms, elt)
    if b * n_gblk > 65535 or hkv > 65535:
        raise ValueError(f"decode_attention: grid (B x head blocks "
                         f"{b * n_gblk}, Hkv {hkv}) exceeds 65535")
    out = torch.empty_like(q)
    part_acc = torch.empty((b, hkv, g, n_split, hd), dtype=torch.float32,
                           device=dev)
    part_m = torch.empty((b, hkv, g, n_split), dtype=torch.float32,
                         device=dev)
    part_l = torch.empty_like(part_m)
    lib = _build.library("decode_attention")
    if q.dtype == torch.float32:
        fn, grid = lib.decode_attention_f32, (gc, gblk, n_gblk, chunk,
                                              n_split, tile)
    else:
        fn, grid = lib.decode_attention_bf16, (n_gblk, chunk, n_split)
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * (5 + len(grid))
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        length.data_ptr(), out.data_ptr(),
                        part_acc.data_ptr(), part_m.data_ptr(),
                        part_l.data_ptr(), b, s, hkv, g, hd, *grid,
                        hd ** -0.5, stream), "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
