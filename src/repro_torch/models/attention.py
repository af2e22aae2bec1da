"""Attention blocks in PyTorch: GQA (full / sliding-window), cross-attention
(whisper's decoder) and MLA (multi-head latent attention, DeepSeek-V2).

Counterpart of ``repro.models.attention``.  Prefill/train uses the
blockwise formulation over query chunks (``q_chunk``), which keeps the live
scores at (B, q_chunk, H, S); the chunk loop is a Python loop where the
reference scans.  Decode reads a KV cache of ``capacity`` slots with a
write cursor ``len``; on the dense path with ``cfg.use_decode_kernel`` (no
ring, no window) the attention itself is the ``decode_attention`` kernel.
MLA decodes against its latent cache (c_kv, k_rope) with the absorbed
matrices, on the einsum path as the reference does.

Caches are updated IN PLACE: ``attention_decode`` and ``mla_decode`` write
the new row into the cache tensors they are given (the reference returns
new arrays), which saves a copy of the whole cache per layer and step.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import dense_init, rope
from repro_torch.models.spmd import (decode_on_mesh, heads_on_mesh,
                                     is_dtensor, whole_heads)

__all__ = ["attn_init", "attention_train", "attention_decode",
           "init_kv_cache", "mla_init", "mla_train", "mla_decode",
           "init_mla_cache", "cross_attn_init", "cross_attention",
           "encode_kv", "NEG_INF"]

NEG_INF = -1e30


# ------------------------------------------------------------------ GQA


def attn_init(gen: torch.Generator, cfg: ModelConfig, dtype,
              layers: int) -> dict:
    """Stacked (layers, ...) GQA weights, (in, out) each."""
    d, h, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    p = {
        "wq": dense_init(gen, layers, (d, h * hd), dtype),
        "wk": dense_init(gen, layers, (d, hkv * hd), dtype),
        "wv": dense_init(gen, layers, (d, hkv * hd), dtype),
        "wo": dense_init(gen, layers, (h * hd, d), dtype),
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
    q, k, v = whole_heads(q, h), whole_heads(k, hkv), whole_heads(v, hkv)
    return (q.reshape(b, s, h, hd), k.reshape(b, s, hkv, hd),
            v.reshape(b, s, hkv, hd))


def _blockwise_scores_softmax(q, k, v, *, q_offset, kv_positions, causal,
                              window, f32=True):
    """One query chunk vs full K/V.  q: (B,qc,Hkv,G,hd); k/v: (B,S,Hkv,hd).

    ``f32=False`` keeps the (qc, S) score/probability tensors in bf16 while
    the max/sum reductions stay in f32 (the reference's perf knob)."""
    hd = q.shape[-1]
    st = torch.float32 if f32 else torch.bfloat16
    scale = torch.tensor(hd, dtype=torch.float32).to(st) ** -0.5
    scores = torch.einsum("bqkgd,bskd->bqkgs", q.to(st), k.to(st)) \
        * scale.to(q.device)
    qpos = q_offset + torch.arange(q.shape[1], device=q.device)
    mask = torch.ones((q.shape[1], k.shape[1]), dtype=torch.bool,
                      device=q.device)
    if causal:
        mask &= kv_positions[None, :] <= qpos[:, None]
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


def _grouped_attention(q, k, v, cfg: ModelConfig, *, causal=True,
                       window=None):
    """Blockwise attention over query chunks.  q: (B,S,H,hd); k/v
    (B,S_kv,Hkv,*) with v's width possibly other than hd (MLA).  DTensors
    (a device mesh) run per rank through ``spmd.heads_on_mesh``."""
    if is_dtensor(q):
        return heads_on_mesh(lambda q, k, v: _grouped_attention(
            q, k, v, cfg, causal=causal, window=window), q, k, v)
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
    truncate = cfg.attn_truncate and causal and window is None
    outs = []
    for i in range(nchunk):
        kv_end = (i + 1) * qc if truncate else k.shape[1]
        outs.append(_blockwise_scores_softmax(
            qg[:, i * qc:(i + 1) * qc], k[:, :kv_end], v[:, :kv_end],
            q_offset=i * qc, kv_positions=kv_positions[:kv_end],
            causal=causal, window=window, f32=cfg.attn_f32))
    return torch.cat(outs, dim=1).reshape(b, sq, h, vd)


def attention_train(params, x, cfg: ModelConfig, *, positions=None,
                    causal=True, window=None, return_kv=False):
    """Full-sequence attention (train / prefill).  x: (B, S, d)."""
    b, s, _ = x.shape
    q, k, v = _qkv(params, x, cfg)
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    if window is None and cfg.attn_kind == "sliding":
        window = cfg.window
    out = _grouped_attention(q, k, v, cfg, causal=causal, window=window)
    out = out.reshape(b, s, -1) @ params["wo"]
    return (out, (k, v)) if return_kv else out


def init_kv_cache(cfg: ModelConfig, batch: int, capacity: int, dtype,
                  device, layers: int | None = None) -> dict:
    hkv, hd = cfg.n_kv_heads, cfg.hd
    n = cfg.n_layers if layers is None else layers
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
    capacity).  ``len`` stays a device scalar throughout: no host sync.  A
    DTensor cache (a device mesh) runs through ``spmd.decode_on_mesh``."""
    b = x.shape[0]
    cur = layer_cache["len"]
    q, k, v = _qkv(params, x, cfg)
    pos = cur.reshape(1, 1).expand(b, 1)
    q = rope(q, pos, cfg.rope_theta)
    k = rope(k, pos, cfg.rope_theta)
    if window is None and cfg.attn_kind == "sliding":
        window = cfg.window
    kc, vc = layer_cache["k"], layer_cache["v"]

    def core(q, k, v, kc, vc, cur):
        return _decode_step(q, k, v, kc, vc, cur, cfg, window=window,
                            ring=ring)

    if is_dtensor(kc):
        out = decode_on_mesh(core, q, k, v, kc, vc, cur, ring=ring,
                             window=window)
    else:
        out = core(q, k, v, kc, vc, cur)
    return out @ params["wo"], layer_cache


def _decode_step(q, k, v, kc, vc, cur, cfg: ModelConfig, *, window, ring):
    """Write the new K/V rows into kc/vc and attend: q (B, 1, H, hd), k/v
    (B, 1, Hkv, hd) -> (B, 1, H hd) in q's dtype."""
    b, _, h, hd = q.shape
    hkv = kc.shape[2]
    capacity = kc.shape[1]
    wp = cur % capacity if ring else torch.clamp(cur, max=capacity - 1)
    slot = wp.reshape(1).long()
    kc.index_copy_(1, slot, k.to(kc.dtype))
    vc.index_copy_(1, slot, v.to(vc.dtype))
    g = h // hkv
    if cfg.use_decode_kernel and not ring and window is None:
        qk = q[:, 0].reshape(b, hkv, g, hd)
        out = ops.decode_attention(qk, kc, vc, wp)
        return out.reshape(b, 1, h * hd)
    qg = q.reshape(b, 1, hkv, g, hd)
    scores = torch.einsum("bqkgd,bskd->bqkgs", qg.float(),
                          kc.float()) * hd ** -0.5
    slots = torch.arange(capacity, device=q.device)
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
    return out.to(q.dtype).reshape(b, 1, h * hd)


# ------------------------------------------ cross-attention (whisper decoder)


def cross_attn_init(gen: torch.Generator, cfg: ModelConfig, dtype,
                    layers: int) -> dict:
    return attn_init(gen, cfg, dtype, layers)


def cross_attention(params, x, enc_kv, cfg: ModelConfig):
    """x: (B, S_dec, d); enc_kv = (k, v): (B, S_enc, Hkv, hd).  No mask,
    no rope, no bias (as the reference)."""
    b, s, _ = x.shape
    q = (x @ params["wq"]).reshape(b, s, cfg.n_heads, cfg.hd)
    k, v = enc_kv
    out = _grouped_attention(q, k, v, cfg, causal=False)
    return out.reshape(b, s, -1) @ params["wo"]


def encode_kv(params, enc_out, cfg: ModelConfig):
    """Cross-attention K/V of the encoder output (B, S_enc, d)."""
    b, s, _ = enc_out.shape
    k = (enc_out @ params["wk"]).reshape(b, s, cfg.n_kv_heads, cfg.hd)
    v = (enc_out @ params["wv"]).reshape(b, s, cfg.n_kv_heads, cfg.hd)
    return k, v


# ------------------------------------------------------------------ MLA


def mla_init(gen: torch.Generator, cfg: ModelConfig, dtype,
             layers: int) -> dict:
    d, h = cfg.d_model, cfg.n_heads
    nope, rdim, vdim = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    dev = gen.device
    return {
        "wq_a": dense_init(gen, layers, (d, cfg.q_lora), dtype),
        "q_norm": torch.ones((layers, cfg.q_lora), dtype=dtype, device=dev),
        "wq_b": dense_init(gen, layers, (cfg.q_lora, h * (nope + rdim)),
                           dtype),
        "wkv_a": dense_init(gen, layers, (d, cfg.kv_lora + rdim), dtype),
        "kv_norm": torch.ones((layers, cfg.kv_lora), dtype=dtype,
                              device=dev),
        "wk_b": dense_init(gen, layers, (cfg.kv_lora, h * nope), dtype),
        "wv_b": dense_init(gen, layers, (cfg.kv_lora, h * vdim), dtype),
        "wo": dense_init(gen, layers, (h * vdim, d), dtype),
    }


def _rmsnorm(x, scale):
    xf = x.float()
    xf = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + 1e-6)
    return (xf * scale.float()).to(x.dtype)


def _mla_qkv_latent(params, x, cfg: ModelConfig, positions):
    """The query (nope and roped parts) and the latent KV (c_kv, roped
    k_rope).  x: (B, S, d)."""
    b, s, _ = x.shape
    h, nope = cfg.n_heads, cfg.qk_nope_dim
    q = _rmsnorm(x @ params["wq_a"], params["q_norm"]) @ params["wq_b"]
    q = q.reshape(b, s, h, nope + cfg.qk_rope_dim)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    q_rope = rope(q_rope, positions, cfg.rope_theta)
    kv = x @ params["wkv_a"]
    c_kv = _rmsnorm(kv[..., :cfg.kv_lora], params["kv_norm"])
    k_rope = rope(kv[..., cfg.kv_lora:], positions, cfg.rope_theta)
    return q_nope, q_rope, c_kv, k_rope


def mla_train(params, x, cfg: ModelConfig, *, positions=None, window=None,
              return_latent=False):
    """MLA for train / prefill: per-head K/V materialised from the latent,
    causal blockwise attention over query chunks."""
    b, s, _ = x.shape
    h = cfg.n_heads
    nope, rdim, vdim = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    q_nope, q_rope, c_kv, k_rope = _mla_qkv_latent(params, x, cfg, positions)
    k_nope = (c_kv @ params["wk_b"]).reshape(b, s, h, nope)
    v = (c_kv @ params["wv_b"]).reshape(b, s, h, vdim)
    q = torch.cat([q_nope, q_rope], -1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(b, s, h, rdim)], -1)
    if window is None and cfg.attn_kind == "sliding":
        window = cfg.window
    out = _grouped_attention(q, k, v, cfg, causal=True, window=window)
    out = out.reshape(b, s, h * vdim) @ params["wo"]
    return (out, (c_kv, k_rope)) if return_latent else out


def init_mla_cache(cfg: ModelConfig, batch: int, capacity: int, dtype,
                   device) -> dict:
    n = cfg.n_layers
    return {
        "c_kv": torch.zeros((n, batch, capacity, cfg.kv_lora), dtype=dtype,
                            device=device),
        "k_rope": torch.zeros((n, batch, capacity, cfg.qk_rope_dim),
                              dtype=dtype, device=device),
        "len": torch.zeros((), dtype=torch.int32, device=device),
    }


def mla_decode(params, x, cfg: ModelConfig, layer_cache: dict, *,
               window=None):
    """Absorbed-matrix MLA decode against the latent cache (c_kv (B, S,
    kv_lora), k_rope (B, S, rdim)), written in place at slot min(len,
    capacity - 1).  x: (B, 1, d).  Returns (out, layer_cache)."""
    b = x.shape[0]
    h = cfg.n_heads
    nope, rdim, vdim = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    cur = layer_cache["len"]
    pos = cur.reshape(1, 1).expand(b, 1)
    q_nope, q_rope, c_kv, k_rope = _mla_qkv_latent(params, x, cfg, pos)
    ckv_c, krope_c = layer_cache["c_kv"], layer_cache["k_rope"]
    capacity = ckv_c.shape[1]
    wp = torch.clamp(cur, max=capacity - 1)
    slot = wp.reshape(1).long()
    ckv_c.index_copy_(1, slot, c_kv.to(ckv_c.dtype))
    krope_c.index_copy_(1, slot, k_rope.to(krope_c.dtype))
    # absorb wk_b into the query: q_lat[h, c] = sum_n q_nope[h, n] wk_b[c,h,n]
    wk_b = params["wk_b"].reshape(cfg.kv_lora, h, nope)
    q_lat = torch.einsum("bqhn,chn->bqhc", q_nope.float(), wk_b.float())
    scores = (torch.einsum("bqhc,bsc->bqhs", q_lat, ckv_c.float())
              + torch.einsum("bqhr,bsr->bqhs", q_rope.float(),
                             krope_c.float())) * (nope + rdim) ** -0.5
    kv_positions = torch.arange(capacity, device=x.device)
    mask = kv_positions <= wp
    if window is None and cfg.attn_kind == "sliding":
        window = cfg.window
    if window is not None:
        mask &= kv_positions > wp - window
    scores = torch.where(mask[None, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    o_lat = torch.einsum("bqhs,bsc->bqhc", probs, ckv_c.float())
    wv_b = params["wv_b"].reshape(cfg.kv_lora, h, vdim)
    out = torch.einsum("bqhc,chv->bqhv", o_lat, wv_b.float())
    out = out.to(x.dtype).reshape(b, 1, h * vdim) @ params["wo"]
    return out, layer_cache
