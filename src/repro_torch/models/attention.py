"""Attention blocks: GQA (full / sliding-window), in PyTorch.

Counterpart of the GQA half of ``repro.models.attention``.  Prefill/train
uses the blockwise formulation over query chunks (``q_chunk``), which keeps
the live scores at (B, q_chunk, H, S); the chunk loop is a Python loop where
the reference scans.  Decode reads a KV cache of ``capacity`` slots with a
write cursor ``len``; on the dense path with ``cfg.use_decode_kernel`` the
attention itself is the ``decode_attention`` kernel.

The cache is updated IN PLACE: ``attention_decode`` writes the new K/V row
into the cache tensors it is given (the reference returns new arrays), which
saves a copy of the whole cache per layer and step.  MLA and
cross-attention come with a later slice.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import rope, truncated_normal

__all__ = ["attn_init", "attention_train", "attention_decode",
           "init_kv_cache", "NEG_INF"]

NEG_INF = -1e30


# ------------------------------------------------------------------ GQA


def attn_init(gen: torch.Generator, cfg: ModelConfig, dtype,
              layers: int) -> dict:
    """Stacked (layers, ...) GQA weights, (in, out) each."""
    d, h, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    p = {
        "wq": truncated_normal(gen, (layers, d, h * hd), d ** -0.5, dtype),
        "wk": truncated_normal(gen, (layers, d, hkv * hd), d ** -0.5, dtype),
        "wv": truncated_normal(gen, (layers, d, hkv * hd), d ** -0.5, dtype),
        "wo": truncated_normal(gen, (layers, h * hd, d), (h * hd) ** -0.5,
                               dtype),
    }
    if cfg.qkv_bias:
        dev = gen.device
        p["bq"] = torch.zeros((layers, h * hd), dtype=dtype, device=dev)
        p["bk"] = torch.zeros((layers, hkv * hd), dtype=dtype, device=dev)
        p["bv"] = torch.zeros((layers, hkv * hd), dtype=dtype, device=dev)
    return p


def _qkv(params, x, cfg: ModelConfig):
    b, s, _ = x.shape
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if cfg.qkv_bias:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    return (q.reshape(b, s, h, hd), k.reshape(b, s, hkv, hd),
            v.reshape(b, s, hkv, hd))


def _blockwise_scores_softmax(q, k, v, *, q_offset, kv_positions, window,
                              f32=True):
    """One query chunk vs full K/V.  q: (B,qc,Hkv,G,hd); k/v: (B,S,Hkv,hd).

    ``f32=False`` keeps the (qc, S) score/probability tensors in bf16 while
    the max/sum reductions stay in f32 (the reference's perf knob)."""
    hd = q.shape[-1]
    st = torch.float32 if f32 else torch.bfloat16
    scale = torch.tensor(hd, dtype=torch.float32).to(st) ** -0.5
    scores = torch.einsum("bqkgd,bskd->bqkgs", q.to(st), k.to(st)) \
        * scale.to(q.device)
    qpos = q_offset + torch.arange(q.shape[1], device=q.device)
    mask = kv_positions[None, :] <= qpos[:, None]          # causal
    if window is not None:
        mask &= kv_positions[None, :] > qpos[:, None] - window
    scores = torch.where(mask[None, :, None, None, :], scores,
                         torch.tensor(NEG_INF, dtype=st, device=q.device))
    if f32:
        probs = torch.softmax(scores, dim=-1)
    else:
        m = scores.float().amax(-1, keepdim=True)
        p = torch.exp(scores - m.to(st))
        probs = p / p.float().sum(-1, keepdim=True).to(st)
    out = torch.einsum("bqkgs,bskd->bqkgd", probs.float(), v.to(st).float())
    return out.to(v.dtype)


def _grouped_attention(q, k, v, cfg: ModelConfig, *, window=None):
    """Causal blockwise attention over query chunks.  q: (B,S,H,hd)."""
    b, sq, h, hd = q.shape
    vd = v.shape[-1]
    hkv = k.shape[2]
    g = h // hkv
    qg = q.reshape(b, sq, hkv, g, hd)
    kv_positions = torch.arange(k.shape[1], device=q.device)
    qc = min(cfg.q_chunk, sq)
    if sq % qc:
        qc = sq  # fallback: single chunk (smoke-scale shapes)
    nchunk = sq // qc
    truncate = cfg.attn_truncate and window is None
    outs = []
    for i in range(nchunk):
        kv_end = (i + 1) * qc if truncate else k.shape[1]
        outs.append(_blockwise_scores_softmax(
            qg[:, i * qc:(i + 1) * qc], k[:, :kv_end], v[:, :kv_end],
            q_offset=i * qc, kv_positions=kv_positions[:kv_end],
            window=window, f32=cfg.attn_f32))
    return torch.cat(outs, dim=1).reshape(b, sq, h, vd)


def attention_train(params, x, cfg: ModelConfig, *, return_kv=False):
    """Full-sequence causal attention (train / prefill).  x: (B, S, d)."""
    b, s, _ = x.shape
    q, k, v = _qkv(params, x, cfg)
    positions = torch.arange(s, device=x.device)[None, :]
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    window = cfg.window if cfg.attn_kind == "sliding" else None
    out = _grouped_attention(q, k, v, cfg, window=window)
    out = out.reshape(b, s, -1) @ params["wo"]
    return (out, (k, v)) if return_kv else out


def init_kv_cache(cfg: ModelConfig, batch: int, capacity: int, dtype,
                  device) -> dict:
    hkv, hd, n = cfg.n_kv_heads, cfg.hd, cfg.n_layers
    return {
        "k": torch.zeros((n, batch, capacity, hkv, hd), dtype=dtype,
                         device=device),
        "v": torch.zeros((n, batch, capacity, hkv, hd), dtype=dtype,
                         device=device),
        "len": torch.zeros((), dtype=torch.int32, device=device),
    }


def attention_decode(params, x, cfg: ModelConfig, layer_cache: dict, *,
                     window=None, ring=False):
    """One-token decode.  x: (B, 1, d); layer_cache k/v: (B, S, Hkv, hd),
    written in place.

    Returns (out, layer_cache).  With ``ring=False`` the new K/V goes to slot
    ``wp = min(len, capacity-1)`` and attention covers slots <= wp; with
    ``ring=True`` the cache is a ring of ``capacity`` slots (slot = pos %
    capacity).  ``len`` stays a device scalar throughout: no host sync."""
    b = x.shape[0]
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    cur = layer_cache["len"]
    q, k, v = _qkv(params, x, cfg)
    pos = cur.reshape(1, 1).expand(b, 1)
    q = rope(q, pos, cfg.rope_theta)
    k = rope(k, pos, cfg.rope_theta)
    kc, vc = layer_cache["k"], layer_cache["v"]
    capacity = kc.shape[1]
    wp = cur % capacity if ring else torch.clamp(cur, max=capacity - 1)
    slot = wp.reshape(1).long()
    kc.index_copy_(1, slot, k.to(kc.dtype))
    vc.index_copy_(1, slot, v.to(vc.dtype))
    if window is None and cfg.attn_kind == "sliding":
        window = cfg.window
    g = h // hkv
    if cfg.use_decode_kernel and not ring and window is None:
        qk = q[:, 0].reshape(b, hkv, g, hd)
        out = ops.decode_attention(qk, kc, vc, wp)
        out = out.reshape(b, 1, h * hd) @ params["wo"]
        return out, layer_cache
    qg = q.reshape(b, 1, hkv, g, hd)
    scores = torch.einsum("bqkgd,bskd->bqkgs", qg.float(),
                          kc.float()) * hd ** -0.5
    slots = torch.arange(capacity, device=x.device)
    if ring:
        # absolute position held by each slot (<= cur, == slot mod capacity)
        kv_positions = cur - torch.remainder(cur - slots, capacity)
        mask = (kv_positions >= 0) & (kv_positions <= cur)
    else:
        kv_positions = slots
        mask = kv_positions <= wp
    if window is not None:
        mask &= kv_positions > cur - window
    scores = torch.where(mask[None, None, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bqkgs,bskd->bqkgd", probs, vc.float())
    out = out.to(x.dtype).reshape(b, 1, h * hd) @ params["wo"]
    return out, layer_cache
