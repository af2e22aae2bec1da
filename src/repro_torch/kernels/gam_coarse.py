"""Coarse GAM LM-head scores against int8 ternary patterns.

``gam_coarse`` launches the CUDA kernel ``csrc/gam_coarse.cu`` on CUDA
tensors; ``gam_coarse_plain`` is its plain PyTorch version (CPU tensors, and
the kernel's reference), the formula of the reference's ``gam_coarse_ref``:
``(h @ patterns) * inv_sqrt_nnz`` in f32.  Counterpart of the Pallas kernel
in ``repro.kernels.gam_coarse``.  No model path of either package calls it:
the GAM head scores through the posting table.

The kernel sums over d on the tensor cores (``mma.sync`` up to 16 query
rows, ``wgmma`` past them), h split exactly into three bf16 terms, one f32
accumulator an output; the plain version's matrix product sums in another
order, so the two agree within the rounding bound of a d-term f32 sum (see
:func:`coarse_tolerance`), not bit for bit.  :func:`coarse_plan` says how a
call is launched.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.kernels import _build

__all__ = ["CoarsePlan", "coarse_plan", "coarse_tolerance", "gam_coarse",
           "gam_coarse_plain", "third_term_errors", "third_term_probe"]

TILE_V = 128                   # V columns a tile (GC_TV)
SMEM_PER_SM = 233_472          # bytes of shared memory an H100 SM holds
SMEM_PER_CTA_RESERVED = 1024   # the card's own reserve a resident CTA
THREADS_PER_SM = 2048
# (query rows a pass, k rows a stage, stages, route) of the kernel's configs,
# in the order of its `cfg` argument (GC_CONFIGS); threads = rows a pass /
# 64 * 128, at least 128.  Route: "mma" (mma.sync, h fragments through
# ldmatrix) or "wgmma" (h read from shared memory by the tensor cores).
CONFIGS = ((8, 128, 3, "mma"), (16, 128, 3, "mma"), (32, 64, 4, "wgmma"),
           (64, 64, 3, "wgmma"), (128, 32, 3, "wgmma"),
           (256, 32, 3, "wgmma"))
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int,
                                     ctypes.c_int64, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_int,
                                     ctypes.c_void_p]
_SMS: dict[int, int] = {}


@dataclass(frozen=True)
class CoarsePlan:
    """How one call runs: ``cfg`` indexes ``CONFIGS`` and sets the
    ``route`` of the products (``mma`` or ``wgmma``); ``vec`` is the TMA
    route (V % 16 == 0, V < 2^31, a 16-byte aligned pattern pointer), else
    pattern pieces are staged by byte loads; ``grid`` persistent CTAs walk the
    ``tiles`` V tiles, ``passes`` times over the patterns (once for
    B <= 256) in ``chunks`` chunks of d; ``scratch`` bf16 elements hold the
    split h, padded to whole passes and chunks."""
    cfg: int
    route: str
    vec: bool
    rows_per_pass: int
    threads: int
    smem: int
    ctas_per_sm: int
    tiles: int
    grid: int
    passes: int
    chunks: int
    scratch: int


def coarse_plan(b: int, d: int, v: int, pattern_offset: int = 0,
                n_sm: int = 132) -> CoarsePlan:
    """The launch of a (b, d) x (d, v) call whose pattern pointer lies
    ``pattern_offset`` bytes past a 16-byte boundary, on ``n_sm`` SMs."""
    cfg = next((i for i, c in enumerate(CONFIGS) if c[0] >= b),
               len(CONFIGS) - 1)
    rows, kd, stages, route = CONFIGS[cfg]
    threads = max(128, rows // 64 * 128)
    chunks = -(-d // kd)
    stage = -(-(kd * TILE_V + kd // 16 * 3 * rows * 32) // 1024) * 1024
    smem = stages * stage + 1024 + 64
    ctas = min(2, SMEM_PER_SM // (smem + SMEM_PER_CTA_RESERVED),
               THREADS_PER_SM // threads)
    tiles = -(-v // TILE_V)
    passes = -(-b // rows)
    vec = v % 16 == 0 and v < 1 << 31 and pattern_offset % 16 == 0
    return CoarsePlan(cfg=cfg, route=route, vec=vec,
                      rows_per_pass=rows, threads=threads, smem=smem,
                      ctas_per_sm=ctas, tiles=tiles,
                      grid=min(tiles, ctas * n_sm), passes=passes,
                      chunks=chunks,
                      scratch=passes * chunks * kd // 16 * 3 * rows * 16)


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


def third_term_probe(b: int, d: int, v: int, seed: int = 0,
                     device=None) -> tuple:
    """Inputs (h, patterns, inv_sqrt_nnz) whose answer lies in the third
    bf16 term of h, for even d: h's columns come in pairs (x, -z), |x| in
    [1, 2) with 23 random significand bits and z = x with the low 8 of them
    cleared, against ternary patterns equal on each pair of rows.  The first
    two terms of each pair then cancel in every 16-deep step and the output
    is sum_pairs p (x - z) inv, a few 2^-16 a term; a product that keeps
    only two terms of h is off by about sum p lo(x) inv (see
    :func:`third_term_errors`)."""
    r = np.random.default_rng(seed)
    x = (r.uniform(1.0, 2.0, (b, d // 2))
         * r.choice([-1.0, 1.0], (b, d // 2))).astype(np.float32)
    z = (x.view(np.uint32) & np.uint32(0xFFFFFF00)).view(np.float32)
    h = np.empty((b, d), np.float32)
    h[:, 0::2], h[:, 1::2] = x, -z
    pat = np.repeat(r.integers(-1, 2, (d // 2, v)).astype(np.int8), 2, 0)
    inv = r.uniform(0.5, 1.0, v).astype(np.float32)
    return tuple(torch.from_numpy(a).to(device) for a in (h, pat, inv))


def third_term_errors(got: torch.Tensor, h: torch.Tensor,
                      patterns: torch.Tensor,
                      inv_sqrt_nnz: torch.Tensor) -> tuple:
    """(max |got - exact|, max |two - exact|): ``exact`` is the product in
    f64 (exact for f32 h and int8 patterns up to d 2^20), ``two`` the same
    product of the first two bf16 terms of h (``attn::split3``'s hi + mid):
    on :func:`third_term_probe`'s inputs a kernel that keeps all three terms
    has the first far below the second."""
    p64, s64 = patterns.double(), inv_sqrt_nnz.double()
    hf = h.float()
    hi = hf.to(torch.bfloat16).float()
    mid = (hf - hi).to(torch.bfloat16).float()
    exact = (hf.double() @ p64) * s64
    two = ((hi.double() + mid.double()) @ p64) * s64
    return (float((got.double() - exact).abs().max()),
            float((two - exact).abs().max()))


def _n_sm(dev: torch.device) -> int:
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


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
    if b >= 1 << 31 or d >= 1 << 31 or -(-v // TILE_V) >= 1 << 31:
        raise ValueError(f"gam_coarse takes B, d and V / {TILE_V} below "
                         f"2^31, got {(b, d, v)}")
    plan = coarse_plan(b, d, v, patterns.data_ptr() % 16, _n_sm(dev))
    out = torch.empty((b, v), dtype=torch.float32, device=dev)
    scratch = torch.empty(plan.scratch, dtype=torch.bfloat16, device=dev)
    fn = _build.entry("gam_coarse", "gam_coarse_f32", _ARGTYPES)
    _build.check(_build.launch(fn, dev, h.data_ptr(), scratch.data_ptr(),
                               patterns.data_ptr(), inv_sqrt_nnz.data_ptr(),
                               out.data_ptr(), b, d, v, plan.cfg,
                               int(plan.vec), plan.grid), "gam_coarse")
    gam_coarse.launches += 1
    return out


gam_coarse.launches = 0
