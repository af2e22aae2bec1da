"""Fused candidate-pruned top-kappa retrieval: host side, plain version and
the wrapper of the CUDA kernel ``csrc/gam_retrieve.cu``.

Counterpart of ``repro.kernels.gam_retrieve`` (f32 path).  Pattern bitsets
are held as ``int32`` tensors with the bits of the reference's ``uint32``
words: torch has no shifts or popcount on ``uint32`` on the CPU, and the bit
pattern is all the kernel reads.  Snapshots convert back to ``uint32``.

``gam_retrieve`` launches the kernel on CUDA tensors;
``gam_retrieve_plain`` is its plain PyTorch version, which walks the item
axis in chunks so a catalog of millions of rows fits in memory.  Both
realise the total order (score desc, row asc) over candidates with the same
f32 arithmetic, so they agree bit for bit.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.gam_score import NEG, dot_plain

__all__ = ["GAM_RETRIEVE_MAX_K", "GAM_RETRIEVE_MAX_KAPPA", "GamRetrieveResult",
           "ROW_CAPACITY", "RetrievalMeta", "RowCapacityError",
           "TOPK_EMPTY_ROW", "build_retrieval_meta", "effective_bq",
           "expand_tile_skips", "export_topk", "gam_retrieve",
           "gam_retrieve_plain", "pack_patterns", "popcount32"]

#: Hard structural-row ceiling (2^30): the reference kernel's non-candidate
#: sentinel row; kept so both packages refuse the same catalogs.
ROW_CAPACITY = 1 << 30

#: Exported sentinel for empty top-kappa slots (int32 max).
TOPK_EMPTY_ROW = np.int32(np.iinfo(np.int32).max)

#: Largest kappa the kernel's shared-memory lists take (room for the int8
#: path's re-rank pool of kappa * rerank_factor).
GAM_RETRIEVE_MAX_KAPPA = 128
#: Widest factor row the kernel stages in shared memory.
GAM_RETRIEVE_MAX_K = 1024

# item elements per chunk of the plain version (bounds its (Q, chunk) temporaries)
_PLAIN_CHUNK = 1 << 24


class RowCapacityError(ValueError):
    """A catalog layout would push structural rows to >= 2^30."""

    def __init__(self, what: str, rows: int):
        super().__init__(
            f"{what} = {rows} rows exceeds the kernel row capacity "
            f"{ROW_CAPACITY} (2^30): row ids would collide with the "
            f"_NO_ROW sentinel. Shard the catalog across hosts instead.")


def effective_bq(q: int, bq: int = 32) -> int:
    """The query-block height the skip map is tiled with: ``bq`` clamped to
    the padded query count (multiple of 8, minimum 8)."""
    return max(8, min(int(bq), -(-int(q) // 8) * 8))


def expand_tile_skips(skipped, q: int, bq: int = 32) -> np.ndarray:
    """(q_blocks, n_blocks) skip map -> (q, n_blocks) per-query bool."""
    sk = np.asarray(skipped, bool)
    return np.repeat(sk, effective_bq(q, bq), axis=0)[:q]


def export_topk(vals, rows, *, offset: int = 0
                ) -> tuple[np.ndarray, np.ndarray]:
    """Kernel-local (vals, rows) -> merge-ready (f32 scores, int32 global rows)
    with empty slots pinned to :data:`TOPK_EMPTY_ROW`."""
    scores = np.asarray(vals, np.float32)
    r = np.asarray(rows, np.int64)
    r = np.where((r < 0) | (scores <= NEG / 2), int(TOPK_EMPTY_ROW),
                 r + int(offset))
    return scores, r.astype(np.int32)


# --------------------------------------------------------------- metadata

_POP8 = torch.tensor([bin(i).count("1") for i in range(256)], dtype=torch.int32)


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Bit count of each int32 element (byte lookup table; any device)."""
    lut = _POP8.to(x.device)
    return (lut[(x & 255).long()] + lut[((x >> 8) & 255).long()]
            + lut[((x >> 16) & 255).long()] + lut[((x >> 24) & 255).long()])


def _int32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 with the same 32 bits."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def pack_patterns(tau, mask, p: int) -> torch.Tensor:
    """(n, k) tau destinations + non-zero mask -> (n, ceil(p/32)) int32 bitsets.

    tau destinations are unique within a row, so a scatter-add of distinct
    powers of two equals the bitwise OR."""
    tau = torch.as_tensor(tau)
    mask = torch.as_tensor(mask, device=tau.device).to(torch.bool)
    words = -(-p // 32)
    t = tau.to(torch.int64)
    vals = torch.where(mask, torch.ones_like(t) << (t % 32), 0)
    out = torch.zeros((t.shape[0], words), dtype=torch.int64, device=t.device)
    return _int32_bits(out.scatter_add_(1, t // 32, vals))


def _or_blocks(bits: torch.Tensor) -> torch.Tensor:
    """(n_blocks, bn, words) -> (n_blocks, words) bitwise OR over bn."""
    while bits.shape[1] > 1:
        if bits.shape[1] % 2:
            bits = torch.cat([bits, torch.zeros_like(bits[:, :1])], dim=1)
        bits = bits[:, 0::2] | bits[:, 1::2]
    return bits[:, 0]


@dataclasses.dataclass(frozen=True)
class RetrievalMeta:
    """Posting-derived block metadata the fused kernel streams against."""

    item_bits_t: torch.Tensor   # (words, n_pad) int32: packed patterns, transposed
    block_union: torch.Tensor   # (n_blocks, words) int32: OR of member patterns
    block_spill: torch.Tensor   # (n_blocks,) bool: block holds a spill row
    spill8: torch.Tensor        # (1, n_pad) int8: unconditional-candidate flag
    p: int                      # pattern-space dimensionality
    words: int                  # ceil(p / 32)
    bn: int                     # item-block width
    n_rows: int                 # structural rows of the factor array served
    n_pad: int                  # n_rows rounded up to a multiple of bn

    @property
    def n_blocks(self) -> int:
        return self.n_pad // self.bn


def build_retrieval_meta(tau, mask, p: int, *, n_rows: int | None = None,
                         spill_rows=None, bn: int = 256,
                         device: str | torch.device = "cpu") -> RetrievalMeta:
    """Build the kernel's block metadata for ``n_rows`` structural rows on
    ``device``; ``tau``/``mask`` are the (n, k) patterns of rows 0..n-1 and
    ``spill_rows`` the rows that are unconditional candidates."""
    tau = torch.as_tensor(tau, device=device)
    mask = torch.as_tensor(mask, device=device).to(torch.bool)
    n = tau.shape[0]
    n_rows = n if n_rows is None else int(n_rows)
    if n_rows < n:
        raise ValueError(f"n_rows={n_rows} < {n} pattern rows")
    words = -(-p // 32)
    bn = max(8, min(int(bn), -(-max(n_rows, 1) // 8) * 8))
    n_blocks = -(-max(n_rows, 1) // bn)
    n_pad = n_blocks * bn
    if n_pad > ROW_CAPACITY:     # before any O(n_pad) allocation
        raise RowCapacityError("padded catalog (n_pad)", n_pad)
    bits = torch.zeros((n_pad, words), dtype=torch.int32, device=device)
    if n:
        bits[:n] = pack_patterns(tau, mask, p)
    spill = torch.zeros(n_pad, dtype=torch.bool, device=device)
    if spill_rows is not None:
        sr = torch.as_tensor(np.asarray(spill_rows, np.int64), device=device)
        spill[sr] = True
    return RetrievalMeta(
        item_bits_t=bits.T.contiguous(),
        block_union=_or_blocks(bits.view(n_blocks, bn, words)).contiguous(),
        block_spill=spill.view(n_blocks, bn).any(dim=1),
        spill8=spill.to(torch.int8)[None, :],
        p=int(p), words=words, bn=bn, n_rows=n_rows, n_pad=n_pad)


# ----------------------------------------------------------------- compute


class GamRetrieveResult(NamedTuple):
    vals: torch.Tensor        # (Q, kappa) f32 exact scores, NEG in empty slots
    rows: torch.Tensor        # (Q, kappa) int32 global rows, -1 in empty slots
    blk_counts: torch.Tensor  # (Q, n_blocks) int32 candidates per item block
    skipped: torch.Tensor     # (q_blocks, n_blocks) bool: tiles never scored


def _skip_map(q_bits, meta: RetrievalMeta, min_overlap: int, bq: int):
    q = q_bits.shape[0]
    ub = popcount32(q_bits[:, None, :] & meta.block_union[None]).sum(-1)
    possible = (ub >= min_overlap) | meta.block_spill[None, :]
    qp = -(-q // bq) * bq
    pad = torch.zeros((qp - q, meta.n_blocks), dtype=torch.bool,
                      device=possible.device)
    possible = torch.cat([possible, pad]).view(qp // bq, bq, meta.n_blocks)
    return ~possible.any(dim=1)


def _alive8(alive, meta: RetrievalMeta, device) -> torch.Tensor:
    out = torch.zeros(meta.n_pad, dtype=torch.int8, device=device)
    if alive is None:
        out[:meta.n_rows] = 1
    else:
        out[:meta.n_rows] = torch.as_tensor(alive, device=device).to(torch.int8)
    return out


def gam_retrieve_plain(users, factors, q_tau, q_mask, meta: RetrievalMeta,
                       kappa: int, *, min_overlap: int = 1, alive=None,
                       bq: int = 32) -> GamRetrieveResult:
    """Plain PyTorch version of :func:`gam_retrieve`, on any device."""
    q = users.shape[0]
    dev = users.device
    bq = effective_bq(q, bq)
    q_bits = pack_patterns(q_tau, q_mask, meta.p)
    skip = _skip_map(q_bits, meta, min_overlap, bq)
    alive8 = _alive8(alive, meta, dev)
    spill8 = meta.spill8[0]
    nb, bn = meta.n_blocks, meta.bn
    vals = torch.full((q, kappa), NEG, dtype=torch.float32, device=dev)
    rows = torch.full((q, kappa), -1, dtype=torch.int32, device=dev)
    counts = torch.zeros((q, nb), dtype=torch.int32, device=dev)
    step = max(1, _PLAIN_CHUNK // max(1, q * bn))
    for b0 in range(0, nb, step):
        b1 = min(nb, b0 + step)
        lo, hi = b0 * bn, b1 * bn
        ov = torch.zeros((q, hi - lo), dtype=torch.int32, device=dev)
        for w in range(meta.words):
            ov += popcount32(q_bits[:, w, None] & meta.item_bits_t[w, None, lo:hi])
        cand = (((ov >= min_overlap) | (spill8[lo:hi] != 0)[None])
                & (alive8[lo:hi] != 0)[None])
        counts[:, b0:b1] = cand.view(q, b1 - b0, bn).sum(-1, dtype=torch.int32)
        scores = torch.full((q, hi - lo), NEG, dtype=torch.float32, device=dev)
        top = min(hi, meta.n_rows)
        if top > lo:
            scores[:, :top - lo] = dot_plain(users, factors[lo:top])
        scores = torch.where(cand, scores, NEG)
        # accumulator first, then the chunk in row order: a stable sort on
        # score desc realises (score desc, row asc)
        cat_s = torch.cat([vals, scores], dim=1)
        cat_r = torch.cat([rows, torch.arange(lo, hi, dtype=torch.int32,
                                              device=dev).expand(q, -1)], dim=1)
        order = torch.argsort(-cat_s, dim=1, stable=True)[:, :kappa]
        vals = torch.gather(cat_s, 1, order)
        rows = torch.gather(cat_r, 1, order)
    rows = torch.where(vals <= NEG / 2, -1, rows)
    return GamRetrieveResult(vals, rows, counts, skip)


def _check(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"gam_retrieve: {name} is on {t.device}, not {device}")
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f"gam_retrieve: {name} must be a contiguous {dtype} "
                         f"tensor of shape {tuple(shape)}, got "
                         f"{t.dtype} {tuple(t.shape)}")


def gam_retrieve(users, factors, q_tau, q_mask, meta: RetrievalMeta,
                 kappa: int, *, min_overlap: int = 1, alive=None,
                 bq: int = 32) -> GamRetrieveResult:
    """Launch the CUDA kernel: fused candidate-pruned top-kappa over
    ``meta.n_rows`` items.

    ``users``: (Q, k) f32; ``factors``: (n_rows, k) f32; ``q_tau``/``q_mask``:
    (Q, k) int32 / bool mapped query patterns; ``alive``: optional (n_rows,)
    bool; ``min_overlap=0`` makes every alive row a candidate (exact path)."""
    dev = users.device
    if dev.type != "cuda":
        raise ValueError(f"gam_retrieve kernel needs CUDA tensors, got {dev}")
    q, k = users.shape
    kappa = int(kappa)
    if not 1 <= kappa <= GAM_RETRIEVE_MAX_KAPPA:
        raise ValueError(f"gam_retrieve supports 1 <= kappa <= "
                         f"{GAM_RETRIEVE_MAX_KAPPA}, got {kappa}")
    if not 1 <= k <= GAM_RETRIEVE_MAX_K or q < 1:
        raise ValueError(f"gam_retrieve supports 1 <= k <= "
                         f"{GAM_RETRIEVE_MAX_K} and Q >= 1, got {(q, k)}")
    _check("users", users, torch.float32, (q, k), dev)
    _check("factors", factors, torch.float32, (meta.n_rows, k), dev)
    _check("q_tau", q_tau, torch.int32, (q, k), dev)
    _check("q_mask", q_mask, torch.bool, (q, k), dev)
    nb = meta.n_blocks
    _check("item_bits_t", meta.item_bits_t, torch.int32,
           (meta.words, meta.n_pad), dev)
    _check("block_union", meta.block_union, torch.int32, (nb, meta.words), dev)
    _check("block_spill", meta.block_spill, torch.bool, (nb,), dev)
    _check("spill8", meta.spill8, torch.int8, (1, meta.n_pad), dev)
    bq = effective_bq(q, bq)
    qblocks = -(-q // bq)
    q_bits = pack_patterns(q_tau, q_mask, meta.p)
    alive8 = _alive8(alive, meta, dev)
    groups = -(-q // 8)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    per_split = -(-nb // min(nb, max(1, -(-sms * 8 // groups))))
    splits = -(-nb // per_split)
    skip = torch.empty((qblocks, nb), dtype=torch.bool, device=dev)
    counts = torch.empty((q, nb), dtype=torch.int32, device=dev)
    part_s = torch.empty((splits, q, kappa), dtype=torch.float32, device=dev)
    part_r = torch.empty((splits, q, kappa), dtype=torch.int32, device=dev)
    vals = torch.empty((q, kappa), dtype=torch.float32, device=dev)
    rows = torch.empty((q, kappa), dtype=torch.int32, device=dev)
    fn = _build.library("gam_retrieve").gam_retrieve_f32
    fn.argtypes = ([ctypes.c_void_p] * 14
                   + [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int64]
                   + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    ptrs = [t.data_ptr() for t in (
        users, factors, q_bits, meta.item_bits_t, meta.block_union,
        meta.block_spill, meta.spill8, alive8, skip, counts, part_s, part_r,
        vals, rows)]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.check(fn(*ptrs, q, k, meta.words, meta.n_pad, meta.bn, nb, bq,
                        qblocks, kappa, int(min_overlap), splits, per_split,
                        stream), "gam_retrieve")
    gam_retrieve.launches += 1
    return GamRetrieveResult(vals, rows, counts, skip)


gam_retrieve.launches = 0
