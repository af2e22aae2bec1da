"""Fused candidate-pruned top-kappa retrieval: host side, plain versions and
the wrappers of the CUDA kernel ``csrc/gam_retrieve.cu``.

Counterpart of ``repro.kernels.gam_retrieve``, f32 and int8 paths.  Pattern
bitsets are held as ``int32`` tensors with the bits of the reference's
``uint32`` words: torch has no shifts or popcount on ``uint32`` on the CPU,
and the bit pattern is all the kernel reads.  Snapshots convert back to ``uint32``.

``gam_retrieve`` launches the kernel on CUDA tensors;
``gam_retrieve_plain`` is its plain PyTorch version, which walks the item
axis in chunks so a catalog of millions of rows fits in memory.  Both
realise the total order (score desc, row asc) over candidates with the same
f32 arithmetic, so they agree bit for bit.  Both also sum each query's
per-block candidate counts over ``segments`` of blocks (a shard each, or
one over the whole catalog), so :func:`fetch_answer` copies the (Q, S) sums
to the host and leaves the (Q, n_blocks) counts on the device.

The int8 path (``meta.quantize == "int8"``, slab attached by
:func:`quantize_meta`): ``gam_retrieve_q`` launches the kernel's int8 entry
and ``gam_retrieve_q_plain`` is its plain version; both score on the slab
decoded as ``float(q) * scale`` per block and keep a pool of
``kappa * rerank_factor`` rows, which :func:`rerank_pool` re-scores against
the exact f32 rows.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.compress.quantize import dequantize_int8, quantize_int8
from repro_torch.device import resolve_device
from repro_torch.kernels import _build
from repro_torch.kernels.gam_score import NEG, dot_plain, fma_dot

__all__ = ["GAM_RETRIEVE_SMEM_K", "GAM_RETRIEVE_SMEM_KAPPA", "GamRetrieveResult",
           "ROW_CAPACITY", "RetrievalMeta", "RowCapacityError",
           "TOPK_EMPTY_ROW", "build_retrieval_meta", "effective_bq",
           "expand_tile_skips", "export_topk", "fetch_answer", "gam_retrieve",
           "gam_retrieve_plain", "gam_retrieve_q", "gam_retrieve_q_plain",
           "pack_patterns", "popcount32", "quantize_meta", "rerank_pool",
           "retrieve_plan"]

#: Hard structural-row ceiling (2^30): the reference kernel's non-candidate
#: sentinel row; kept so both packages refuse the same catalogs.
ROW_CAPACITY = 1 << 30

#: Exported sentinel for empty top-kappa slots (int32 max).
TOPK_EMPTY_ROW = np.int32(np.iinfo(np.int32).max)

#: Largest kappa (or int8 re-rank pool) whose lists the kernel keeps in
#: shared memory: up to it the fast route (:func:`retrieve_plan`) runs where
#: the tiles fit; past it the wide route keeps them in global memory.
GAM_RETRIEVE_SMEM_KAPPA = 128
#: Widest query row the wide route stages in shared memory; wider rows are
#: read from global memory.
GAM_RETRIEVE_SMEM_K = 1024

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
    quantize: str = "none"                  # "none" | "int8"
    factors_q: torch.Tensor | None = None   # (n_pad, k) int8 quantized factors
    scales: torch.Tensor | None = None      # (1, n_blocks) f32 dequant scales

    @property
    def n_blocks(self) -> int:
        return self.n_pad // self.bn


def quantize_meta(meta: RetrievalMeta, factors) -> RetrievalMeta:
    """Attach an int8 factor slab + per-block scales to ``meta``, on its
    device.  ``factors``: (m, k) f32 with m <= n_pad; rows past m quantize
    as zeros (structural pads).  One scale per ``bn``-row kernel block."""
    dev = meta.item_bits_t.device
    f = torch.as_tensor(factors, dtype=torch.float32, device=dev)
    if f.dim() != 2 or f.shape[0] > meta.n_pad:
        raise ValueError(f"factors shape {tuple(f.shape)} does not fit "
                         f"n_pad={meta.n_pad}")
    fp = torch.zeros((meta.n_pad, f.shape[1]), dtype=torch.float32,
                     device=dev)
    fp[:f.shape[0]] = f
    q, scales = quantize_int8(fp, block=meta.bn)
    return dataclasses.replace(meta, quantize="int8", factors_q=q,
                               scales=scales.reshape(1, -1))


def build_retrieval_meta(tau, mask, p: int, *, n_rows: int | None = None,
                         spill_rows=None, bn: int = 256, factors=None,
                         quantize: str = "none",
                         device: str | torch.device | None = None
                         ) -> RetrievalMeta:
    """Build the kernel's block metadata for ``n_rows`` structural rows on
    ``device`` (``None``: the card; ``"cpu"`` for the plain path);
    ``tau``/``mask`` are the (n, k) patterns of rows 0..n-1 and
    ``spill_rows`` the rows that are unconditional candidates.
    ``quantize="int8"`` also quantizes ``factors`` (required then) into the
    slab the int8 kernel decodes."""
    if quantize not in ("none", "int8"):
        raise ValueError(f"unknown quantize mode {quantize!r}")
    device = resolve_device(device)
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
    meta = RetrievalMeta(
        item_bits_t=bits.T.contiguous(),
        block_union=_or_blocks(bits.view(n_blocks, bn, words)).contiguous(),
        block_spill=spill.view(n_blocks, bn).any(dim=1),
        spill8=spill.to(torch.int8)[None, :],
        p=int(p), words=words, bn=bn, n_rows=n_rows, n_pad=n_pad)
    if quantize == "int8":
        if factors is None:
            raise ValueError("quantize='int8' requires the factor slab")
        meta = quantize_meta(meta, factors)
    return meta


# ----------------------------------------------------------------- compute


class GamRetrieveResult(NamedTuple):
    vals: torch.Tensor        # (Q, kappa) f32 exact scores, NEG in empty slots
    rows: torch.Tensor        # (Q, kappa) int32 global rows, -1 in empty slots
    blk_counts: torch.Tensor  # (Q, n_blocks) int32 candidates per item block
    skipped: torch.Tensor     # (q_blocks, n_blocks) bool: tiles never scored
    seg_counts: torch.Tensor | None = None  # (Q, S) int32: by segment


_BOUNDS: dict = {}


def _segment_bounds(segments, n_blocks: int) -> tuple:
    """The S + 1 block offsets of the segments that start at the blocks
    ``segments`` (the first 0, non-decreasing; ``None``: one segment over
    every block); the last segment ends at ``n_blocks``."""
    starts = (0,) if segments is None else tuple(int(b) for b in segments)
    if (not starts or starts[0] != 0 or starts[-1] > n_blocks
            or any(b < a for a, b in zip(starts, starts[1:]))):
        raise ValueError(f"segments must start at block 0 and rise to at "
                         f"most {n_blocks}, got {starts}")
    return starts + (int(n_blocks),)


def _bounds_tensor(bounds: tuple, device) -> torch.Tensor:
    """``bounds`` as an int32 tensor on ``device``, made once and reused, so
    a request copies no offsets to the card."""
    key = (str(device), bounds)
    t = _BOUNDS.get(key)
    if t is None:
        if len(_BOUNDS) >= 256:         # repartitions make new layouts
            _BOUNDS.clear()
        t = _BOUNDS[key] = torch.tensor(bounds, dtype=torch.int32,
                                        device=device)
    return t


def _segment_sums(counts: torch.Tensor, bounds: tuple) -> torch.Tensor:
    """(Q, n_blocks) int32 counts -> (Q, S) int32 sums over the segments
    [bounds[s], bounds[s + 1]): exact, as the kernel's."""
    run = torch.nn.functional.pad(counts.cumsum(1, dtype=torch.int64), (1, 0))
    b = torch.as_tensor(bounds, device=counts.device)
    return (run[:, b[1:]] - run[:, b[:-1]]).to(torch.int32)


class Answer(NamedTuple):
    """A call's answer on the host (:func:`fetch_answer`)."""
    vals: np.ndarray               # (Q, kappa) f32
    rows: np.ndarray               # (Q, kappa) int32
    seg_counts: np.ndarray         # (Q, S) int64 candidates by segment
    blk_counts: np.ndarray | None  # (Q, n_blocks) int32, under full_counts
    skipped: np.ndarray | None     # (q_blocks, n_blocks) bool, likewise
    nbytes: int                    # bytes copied from the device


def fetch_answer(res: GamRetrieveResult, *, full_counts: bool) -> Answer:
    """Copy a call's answer to the host: the (Q, kappa) scores and rows and
    the (Q, S) candidate sums (widened to int64), and only under
    ``full_counts`` (``explain``) the (Q, n_blocks) counts and the skip map.
    ``fetch_answer.summed`` / ``.full`` count the answers fetched each way."""
    host = [res.vals.cpu().numpy(), res.rows.cpu().numpy(),
            res.seg_counts.cpu().numpy()]
    if full_counts:
        host += [res.blk_counts.cpu().numpy(), res.skipped.cpu().numpy()]
        fetch_answer.full += 1
    else:
        host += [None, None]
        fetch_answer.summed += 1
    nbytes = sum(a.nbytes for a in host if a is not None)
    host[2] = host[2].astype(np.int64)
    return Answer(*host, nbytes)


fetch_answer.summed = 0
fetch_answer.full = 0


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


def _plain_walk(users, rows_f32, q_tau, q_mask, meta: RetrievalMeta,
                kappa: int, min_overlap: int, alive, bq: int, segments
                ) -> GamRetrieveResult:
    """The plain item walk; ``rows_f32(lo, hi)`` gives the f32 factor rows
    lo..hi-1 that are scored."""
    bounds = _segment_bounds(segments, meta.n_blocks)
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
            scores[:, :top - lo] = dot_plain(users, rows_f32(lo, top))
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
    return GamRetrieveResult(vals, rows, counts, skip,
                             _segment_sums(counts, bounds))


def gam_retrieve_plain(users, factors, q_tau, q_mask, meta: RetrievalMeta,
                       kappa: int, *, min_overlap: int = 1, alive=None,
                       bq: int = 32, segments=None) -> GamRetrieveResult:
    """Plain PyTorch version of :func:`gam_retrieve`, on any device."""
    return _plain_walk(users, lambda lo, hi: factors[lo:hi], q_tau, q_mask,
                       meta, kappa, min_overlap, alive, bq, segments)


def gam_retrieve_q_plain(users, q_tau, q_mask, meta: RetrievalMeta,
                         pool: int, *, min_overlap: int = 1, alive=None,
                         bq: int = 32, segments=None) -> GamRetrieveResult:
    """Plain PyTorch version of :func:`gam_retrieve_q`, on any device: the
    f32 walk over the slab decoded as ``float(q) * scale`` of its block (the
    reference's in-kernel decode), keeping the top ``pool``."""
    if meta.quantize != "int8":
        raise ValueError("gam_retrieve_q needs a meta with an int8 slab "
                         "(quantize_meta)")
    bn = meta.bn

    def decode(lo, hi):      # lo is block-aligned; hi may cut into a block
        b0, b1 = lo // bn, -(-hi // bn)
        rows = dequantize_int8(meta.factors_q[b0 * bn:b1 * bn],
                               meta.scales[0, b0:b1], bn)
        return rows[:hi - lo]

    return _plain_walk(users, decode, q_tau, q_mask, meta, pool, min_overlap,
                       alive, bq, segments)


def rerank_pool(pool_res: GamRetrieveResult, users, factors,
                kappa: int) -> GamRetrieveResult:
    """Exact f32 re-rank of a quantized-score candidate pool, on the
    tensors' device.

    Each valid pool row is re-scored against its exact f32 factor row with
    the kernels' arithmetic (:func:`fma_dot`, so served scores equal the
    dense oracle's), then the top ``kappa`` are taken under (score desc, row
    asc), empty slots keyed :data:`TOPK_EMPTY_ROW` and returned as
    ``(NEG, -1)``.  Counts, their sums and skips carry over from the pool."""
    rows_p, vals_p = pool_res.rows, pool_res.vals
    valid = (rows_p >= 0) & (vals_p > NEG / 2)
    idx = torch.where(valid, rows_p, 0).long()
    ex = torch.where(valid, fma_dot(users[:, None, :], factors[idx]), NEG)
    key = torch.where(valid, rows_p.long(), int(TOPK_EMPTY_ROW))
    by_row = torch.argsort(key, dim=1, stable=True)
    ex, key = torch.gather(ex, 1, by_row), torch.gather(key, 1, by_row)
    order = torch.argsort(-ex, dim=1, stable=True)[:, :kappa]
    vals, key = torch.gather(ex, 1, order), torch.gather(key, 1, order)
    rows = torch.where(key == int(TOPK_EMPTY_ROW), -1, key).to(torch.int32)
    return GamRetrieveResult(vals, rows, pool_res.blk_counts,
                             pool_res.skipped, pool_res.seg_counts)


def _check(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"gam_retrieve: {name} is on {t.device}, not {device}")
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f"gam_retrieve: {name} must be a contiguous {dtype} "
                         f"tensor of shape {tuple(shape)}, got "
                         f"{t.dtype} {tuple(t.shape)}")


def _check_common(users, q_tau, q_mask, meta: RetrievalMeta, kappa: int,
                  what: str) -> None:
    dev = users.device
    if dev.type != "cuda":
        raise ValueError(f"{what} kernel needs CUDA tensors, got {dev}")
    q, k = users.shape
    if kappa < 1 or k < 1 or q < 1:
        raise ValueError(f"{what} needs kappa, k and Q >= 1, got "
                         f"{(kappa, k, q)}")
    _check("users", users, torch.float32, (q, k), dev)
    _check("q_tau", q_tau, torch.int32, (q, k), dev)
    _check("q_mask", q_mask, torch.bool, (q, k), dev)
    nb = meta.n_blocks
    _check("item_bits_t", meta.item_bits_t, torch.int32,
           (meta.words, meta.n_pad), dev)
    _check("block_union", meta.block_union, torch.int32, (nb, meta.words), dev)
    _check("block_spill", meta.block_spill, torch.bool, (nb,), dev)
    _check("spill8", meta.spill8, torch.int8, (1, meta.n_pad), dev)


_plans: dict = {}


def retrieve_plan(q: int, k: int, words: int, kappa: int, n_blocks: int,
                  quantized: bool, device) -> dict:
    """The kernel's route and grid for a call of this shape on ``device``
    (a CUDA device): ``route`` is ``"fast"`` (query tiles against staged
    item tiles, overlaps on the tensor cores) or ``"wide"`` (a warp per
    query, for kappa past :data:`GAM_RETRIEVE_SMEM_KAPPA` or rows too wide
    for the fast route's shared memory); ``q_tile``, ``splits``,
    ``blocks_per_split``, ``smem`` bytes a CTA and ``ctas_per_sm``."""
    device = torch.device(device)
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    key = (index, q, k, words, kappa, n_blocks, bool(quantized))
    plan = _plans.get(key)
    if plan is None:
        out = (ctypes.c_int * 6)()
        fn = _build.library("gam_retrieve").gam_retrieve_plan
        fn.argtypes = [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
        with torch.cuda.device(index):
            _build.check(fn(q, k, words, kappa, int(bool(quantized)),
                            n_blocks, out), "gam_retrieve_plan")
        plan = {"route": "fast" if out[0] else "wide", "q_tile": 16 * out[1],
                "splits": out[2], "blocks_per_split": out[3], "smem": out[4],
                "ctas_per_sm": out[5]}
        _plans[key] = plan
    return plan


def _entry(name: str):
    """The library's entry ``name`` with its argument types set."""
    fn = getattr(_build.library("gam_retrieve"), name)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 19
                       + [ctypes.c_int] * 3 + [ctypes.c_int64] * 2
                       + [ctypes.c_int] * 11 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _alive_arg(alive, meta: RetrievalMeta, device):
    """``alive`` as the kernel reads it: None (every row alive) or a
    contiguous (n_rows,) bool tensor on ``device``."""
    if alive is None:
        return None
    a = torch.as_tensor(alive, device=device)
    if a.dtype != torch.bool:
        a = a.to(torch.bool)
    if tuple(a.shape) != (meta.n_rows,):
        raise ValueError(f"gam_retrieve: alive must have shape "
                         f"({meta.n_rows},), got {tuple(a.shape)}")
    return a.contiguous()


def _launch(entry: str, users, rows: list, q_tau, q_mask,
            meta: RetrievalMeta, kappa: int, min_overlap: int, alive,
            bq: int, segments) -> GamRetrieveResult:
    """Allocate the outputs and launch ``entry`` of the library; ``rows``
    are the factor tensors the entry reads (f32 rows, or slab + scales).
    The query bitsets are packed on the card by the library."""
    dev = users.device
    q, k = users.shape
    nb = meta.n_blocks
    bq = effective_bq(q, bq)
    qblocks = -(-q // bq)
    alive = _alive_arg(alive, meta, dev)
    seg = _bounds_tensor(_segment_bounds(segments, nb), dev)
    nseg = seg.shape[0] - 1
    quantized = entry == "gam_retrieve_i8"
    plan = retrieve_plan(q, k, meta.words, kappa, nb, quantized, dev)
    splits = plan["splits"]
    # one allocation for the scratch and the outputs (int32 words)
    sizes = (q * meta.words, q * nb, splits * q * kappa, splits * q * kappa,
             q * kappa, q * kappa, q * nseg, -(-qblocks * nb // 4))
    ws = torch.empty(sum(sizes), dtype=torch.int32, device=dev)
    q_bits, counts, part_s, part_r, vals, out_rows, seg_counts, skip = \
        torch.split(ws, sizes)
    counts = counts.view(q, nb)
    vals = vals.view(torch.float32).view(q, kappa)
    out_rows = out_rows.view(q, kappa)
    seg_counts = seg_counts.view(q, nseg)
    skip = skip.view(torch.uint8)[:qblocks * nb].view(torch.bool).view(
        qblocks, nb)
    factors, scales = (rows[0], rows[1]) if quantized else (rows[0], None)
    ptrs = [None if t is None else t.data_ptr() for t in (
        users, factors, scales, q_tau, q_mask, meta.item_bits_t,
        meta.block_union, meta.block_spill, meta.spill8, alive, q_bits, skip,
        counts, part_s, part_r, vals, out_rows, seg, seg_counts)]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.check(_entry(entry)(
            *ptrs, q, k, meta.words, meta.n_pad, meta.n_rows, meta.bn, nb,
            bq, qblocks, kappa, int(min_overlap),
            int(plan["route"] == "fast"), plan["q_tile"] // 16, splits,
            plan["blocks_per_split"], nseg, stream), entry)
    return GamRetrieveResult(vals, out_rows, counts, skip, seg_counts)


def gam_retrieve(users, factors, q_tau, q_mask, meta: RetrievalMeta,
                 kappa: int, *, min_overlap: int = 1, alive=None,
                 bq: int = 32, segments=None) -> GamRetrieveResult:
    """Launch the CUDA kernel: fused candidate-pruned top-kappa over
    ``meta.n_rows`` items.

    ``users``: (Q, k) f32; ``factors``: (n_rows, k) f32; ``q_tau``/``q_mask``:
    (Q, k) int32 / bool mapped query patterns; ``alive``: optional (n_rows,)
    bool; ``min_overlap=0`` makes every alive row a candidate (exact path);
    ``segments``: the first block of each segment whose candidates
    ``seg_counts`` sums (``None``: one segment, every block)."""
    kappa = int(kappa)
    _check_common(users, q_tau, q_mask, meta, kappa, "gam_retrieve")
    _check("factors", factors, torch.float32, (meta.n_rows, users.shape[1]),
           users.device)
    res = _launch("gam_retrieve_f32", users, [factors], q_tau, q_mask, meta,
                  kappa, min_overlap, alive, bq, segments)
    gam_retrieve.launches += 1
    return res


gam_retrieve.launches = 0


def gam_retrieve_q(users, q_tau, q_mask, meta: RetrievalMeta, pool: int, *,
                   min_overlap: int = 1, alive=None, bq: int = 32,
                   segments=None) -> GamRetrieveResult:
    """Launch the CUDA kernel's int8 entry: as :func:`gam_retrieve`, scoring
    on ``meta.factors_q`` (n_pad, k) int8 decoded with ``meta.scales``
    (1, n_blocks) f32, keeping the top ``pool`` for :func:`rerank_pool`
    (in shared memory up to :data:`GAM_RETRIEVE_SMEM_KAPPA` rows)."""
    pool = int(pool)
    _check_common(users, q_tau, q_mask, meta, pool, "gam_retrieve_q")
    if meta.quantize != "int8":
        raise ValueError("gam_retrieve_q needs a meta with an int8 slab "
                         "(quantize_meta)")
    dev = users.device
    _check("factors_q", meta.factors_q, torch.int8,
           (meta.n_pad, users.shape[1]), dev)
    _check("scales", meta.scales, torch.float32, (1, meta.n_blocks), dev)
    res = _launch("gam_retrieve_i8", users, [meta.factors_q, meta.scales],
                  q_tau, q_mask, meta, pool, min_overlap, alive, bq, segments)
    gam_retrieve_q.launches += 1
    return res


gam_retrieve_q.launches = 0
