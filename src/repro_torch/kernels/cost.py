"""The work of each kernel entry of ``ops``, for the cost analysis.

A cost counter (``launch.cost.CostCounter``, a dispatch mode) counts the
aten ops a program runs.  A hand-written kernel is invisible to it: it is
launched through ``ctypes``, not the dispatcher.  So each ``ops`` entry
runs through :func:`run`, which charges every active counter with the
entry's work by the formulas below and keeps the counter from counting
whatever runs beneath it (the plain version on the CPU, the wrapper's own
small ops on the card).  The count is then the same on CPU, meta and CUDA
tensors.  On meta tensors the entry makes outputs of the right shape and
dtype (:func:`meta_outputs`) and launches nothing.

The formulas are the ones ``chip_smoke.py`` uses for the bounds of its
kernel table: bytes read once and written once, operations by the unit
that runs them.  Where that count reads the data (the candidates a query
keeps, the positions a decode attends), these take what the shapes allow
(every pair, every cache position), since a meta tensor holds no data.

A cost is ``(flops, bytes)`` with ``flops`` a dict ``{unit: operations}``;
the units are ``"bf16"`` (the bf16 / f16 tensor cores), ``"f32"`` (f32
outside the tensor cores) and ``"int8"``.
"""
from __future__ import annotations

import contextlib

import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

__all__ = ["FORMULAS", "run", "meta_outputs", "active_counters"]

_F32 = 4


def _half(dtype) -> bool:
    return dtype in (torch.bfloat16, torch.float16)


def tess_project(z):
    """(n, k) f32 in; (n, k) int8 pattern and (n, k) f32 a out; three
    operations an element (|z|, the running sum, the scaled compare)."""
    n, k = z.shape
    return {"f32": 3.0 * k * n}, n * k * (_F32 + 1 + _F32)


def gam_score(u, v, mask):
    """u (Q, k), v (N, k), mask (Q, N) in; (Q, N) f32 out; 2k a pair on
    the CUDA cores (every pair: the mask's ones are data)."""
    q, k = u.shape
    n = v.shape[0]
    return ({"f32": 2.0 * k * q * n},
            q * k * u.element_size() + n * k * v.element_size()
            + q * n * (mask.element_size() + _F32))


def _retrieve(users, meta, kappa: int, bq: int, factor_bytes: int):
    from repro_torch.kernels.gam_retrieve import effective_bq
    q, k = users.shape
    nb, words, bn = meta.n_blocks, meta.words, meta.bn
    qb = -(-q // effective_bq(q, bq))
    n_bytes = (q * k * (_F32 + 1 + _F32)            # users, mask, tau
               + nb * (words * _F32 + 1)            # block unions, spill
               + nb * bn * (words * _F32 + 2)       # item bits, spill, alive
               + q * nb * _F32 + qb * nb            # counts, skip map out
               + factor_bytes                       # the scored rows
               + q * kappa * 2 * _F32)              # the top-kappa out
    return {"f32": 2.0 * k * q * meta.n_rows}, n_bytes


def gam_retrieve(users, factors, q_tau, q_mask, meta, kappa, *, bq=32,
                 **_):
    """chip_smoke's ``retrieve_work`` with every block kept and every row
    a candidate."""
    k = users.shape[1]
    return _retrieve(users, meta, int(kappa), bq, meta.n_rows * k * _F32)


def gam_retrieve_pool(users, q_tau, q_mask, meta, pool, *, bq=32, **_):
    """As :func:`gam_retrieve` on the int8 slab and its block scales."""
    k = users.shape[1]
    return _retrieve(users, meta, int(pool), bq,
                     meta.n_pad * k + meta.n_blocks * _F32)


def decode_attention(q, k, v, length):
    """q (B, Hkv, G, hd), k/v (B, S, Hkv, hd): the cache read once over all
    S positions, q read and the output written; 4 hd operations a (query
    head, position) on the unit of q's dtype."""
    b, hkv, g, hd = q.shape
    s = k.shape[1]
    n_bytes = (2 * b * s * hkv * hd * k.element_size()
               + 2 * q.numel() * q.element_size())
    unit = "bf16" if _half(q.dtype) else "f32"
    return {unit: 4.0 * b * hkv * g * hd * s}, n_bytes


def flash_prefill(q, k, v):
    """q (B, S, Hkv, G, hd), k/v (B, S, Hkv, hd), causal: q.k once and p.v
    three times (p as three exact bf16 terms) on the bf16 tensor cores;
    in f32 both products once on the CUDA cores."""
    b, s, hkv, g, hd = q.shape
    half = 2.0 * b * hkv * g * hd * s * (s + 1) / 2
    n_bytes = (2 * q.numel() * q.element_size()
               + (k.numel() + v.numel()) * k.element_size())
    if _half(q.dtype):
        return {"bf16": 4 * half}, n_bytes
    return {"f32": 2 * half}, n_bytes


def gam_coarse(h, patterns, inv_sqrt_nnz):
    """h (B, d) f32, patterns (d, V) int8, inv (V,) f32 in; (B, V) f32
    out; three bf16 products (h as three exact bf16 terms)."""
    b, d = h.shape
    v = patterns.shape[1]
    return ({"bf16": 3 * 2.0 * b * d * v},
            b * d * _F32 + d * v + v * _F32 + b * v * _F32)


FORMULAS = {"tess_project": tess_project, "gam_score": gam_score,
            "gam_retrieve": gam_retrieve,
            "gam_retrieve_pool": gam_retrieve_pool,
            "decode_attention": decode_attention,
            "flash_prefill": flash_prefill, "gam_coarse": gam_coarse}


def meta_outputs(name: str, *args, **kw):
    """What entry ``name`` returns, as meta tensors of the right shape and
    dtype; nothing runs."""
    meta = torch.device("meta")
    if name in ("decode_attention", "flash_prefill"):
        return torch.empty_like(args[0], device=meta)
    if name == "tess_project":
        z = args[0]
        return (torch.empty(z.shape, dtype=torch.int8, device=meta),
                torch.empty(z.shape, dtype=torch.float32, device=meta))
    if name == "gam_score":
        return torch.empty((args[0].shape[0], args[1].shape[0]),
                           dtype=torch.float32, device=meta)
    if name == "gam_coarse":
        return torch.empty((args[0].shape[0], args[1].shape[1]),
                           dtype=torch.float32, device=meta)
    from repro_torch.kernels.gam_retrieve import (GamRetrieveResult,
                                                  effective_bq)
    users, meta_ = args[0], args[4 if name == "gam_retrieve" else 3]
    width = int(args[5] if name == "gam_retrieve" else args[4])
    q, nb = users.shape[0], meta_.n_blocks
    qb = -(-q // effective_bq(q, kw.get("bq", 32)))
    return GamRetrieveResult(
        torch.empty((q, width), dtype=torch.float32, device=meta),
        torch.empty((q, width), dtype=torch.int32, device=meta),
        torch.empty((q, nb), dtype=torch.int32, device=meta),
        torch.empty((qb, nb), dtype=torch.bool, device=meta))


def active_counters() -> list:
    """The cost counters on the dispatch-mode stack (any mode with a
    ``charge_kernel`` method), innermost last."""
    return [m for m in _get_current_dispatch_mode_stack()
            if hasattr(m, "charge_kernel")]


def run(name: str, fn, *args, **kw):
    """One call of the ``ops`` entry ``name``: ``fn(*args, **kw)`` (the
    plain version or the kernel), or on meta tensors :func:`meta_outputs`.
    Every active counter is charged the entry's work, counts nothing that
    runs beneath it, and tracks the result's memory.  Without a counter
    this costs one look at the mode stack."""
    on_meta = args[0].device.type == "meta"
    counters = active_counters()
    if not counters:
        return meta_outputs(name, *args, **kw) if on_meta else fn(*args, **kw)
    flops, n_bytes = FORMULAS[name](*args, **kw)
    with contextlib.ExitStack() as stack:
        for c in counters:
            stack.enter_context(c.quiet())
        out = meta_outputs(name, *args, **kw) if on_meta else fn(*args, **kw)
    for c in counters:
        c.charge_kernel(name, flops, n_bytes, out)
    return out
