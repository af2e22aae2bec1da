"""Pre-norm residual blocks of every family and their stacked init.

Counterpart of ``repro.models.transformer``: a block is a mixer (``attn``
GQA, ``mla``, ``ssm`` Mamba-2 or ``rec`` RG-LRU), optionally
cross-attention to an encoder (whisper's decoder), then the SwiGLU MLP or
the MoE FFN (the ``ssm`` block has no MLP).  Parameters are stacked over
layers, as the reference's ``vmap``-ed init leaves them: ``stack_init``
returns one tree whose leaves carry a leading (L,) axis, and a block runs
on the layer slice ``layer_params(blocks, i)`` (views, no copies).

``block_prefill`` and ``block_decode`` write the block's decode cache in
place: the cache tensors they are given are that layer's slices of the
model's stacked cache.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (apply_norm, norm_init, swiglu,
                                       swiglu_init)

__all__ = ["MIXERS", "mixer_for_layer", "block_train", "block_prefill",
           "block_decode", "stack_init", "layer_params"]

MIXERS = ("attn", "mla", "ssm", "rec")


def mixer_for_layer(cfg: ModelConfig, layer: int) -> str:
    if cfg.family == "ssm":
        return "ssm"
    if cfg.family == "hybrid":
        return "rec" if layer % 3 != 2 else "attn"
    if cfg.use_mla:
        return "mla"
    return "attn"


def stack_init(gen: torch.Generator, cfg: ModelConfig, mixer: str,
               layers: int, dtype, *, cross: bool = False) -> dict:
    """Stacked (layers, ...) parameters of one kind of block, with the
    reference's leaves."""
    dev = gen.device
    p: dict = {"norm1": norm_init(cfg, dtype, dev, (layers,))}
    if mixer == "attn":
        p["attn"] = attn.attn_init(gen, cfg, dtype, layers)
    elif mixer == "mla":
        p["attn"] = attn.mla_init(gen, cfg, dtype, layers)
    elif mixer == "ssm":
        p["ssm"] = ssm_mod.ssm_init(gen, cfg, dtype, layers)
        return p                                   # mamba2: no separate MLP
    elif mixer == "rec":
        p["rec"] = rglru_mod.rglru_init(gen, cfg, dtype, layers)
    else:
        raise ValueError(f"unknown mixer {mixer!r}")
    if cross:
        p["norm_x"] = norm_init(cfg, dtype, dev, (layers,))
        p["cross"] = attn.cross_attn_init(gen, cfg, dtype, layers)
    p["norm2"] = norm_init(cfg, dtype, dev, (layers,))
    if cfg.family == "moe":
        p["moe"] = moe_mod.moe_init(gen, cfg, dtype, layers)
    else:
        p["mlp"] = swiglu_init(gen, layers, cfg.d_model, cfg.d_ff, dtype)
    return p


def layer_params(tree, i: int):
    """The i-th layer of a stacked parameter tree (views)."""
    if isinstance(tree, dict):
        return {k: layer_params(v, i) for k, v in tree.items()}
    return tree[i]


def _ffn(params, x, cfg: ModelConfig):
    """The block's second half: norm2, then the MLP or the MoE FFN.
    Returns (x, aux)."""
    h = apply_norm(params["norm2"], x, cfg)
    if cfg.family == "moe":
        h, aux = moe_mod.moe_ffn(params["moe"], h, cfg)
        return x + h, aux
    return x + swiglu(params["mlp"], h), torch.zeros(
        (), dtype=torch.float32, device=x.device)


def block_train(params, x, cfg: ModelConfig, mixer: str, *, causal=True,
                window=None, enc_out=None):
    """Pre-norm residual block, full sequence.  Returns (x, aux_loss)."""
    h = apply_norm(params["norm1"], x, cfg)
    if mixer == "attn":
        h = attn.attention_train(params["attn"], h, cfg, causal=causal,
                                 window=window)
    elif mixer == "mla":
        h = attn.mla_train(params["attn"], h, cfg, window=window)
    elif mixer == "ssm":
        return x + ssm_mod.ssm_train(params["ssm"], h, cfg), torch.zeros(
            (), dtype=torch.float32, device=x.device)
    elif mixer == "rec":
        h = rglru_mod.rglru_train(params["rec"], h, cfg)
    x = x + h
    if enc_out is not None and "cross" in params:
        h = apply_norm(params["norm_x"], x, cfg)
        enc_kv = attn.encode_kv(params["cross"], enc_out, cfg)
        x = x + attn.cross_attention(params["cross"], h, enc_kv, cfg)
    return _ffn(params, x, cfg)


def _fill(dst: torch.Tensor, seq: torch.Tensor, ring: bool) -> None:
    """Write the prompt's rows seq (B, S, ...) into a cache slice dst (B,
    capacity, ...): slots [0, S), or with ``ring`` the trailing min(S,
    capacity) positions p at slot p % capacity (the rest stays zero, as the
    reference's padding leaves it)."""
    s, capacity = seq.shape[1], dst.shape[1]
    if not ring:
        dst[:, :s] = seq
        return
    m = min(s, capacity)
    slots = torch.arange(s - m, s, device=dst.device) % capacity
    dst[:, slots] = seq[:, s - m:]


def block_prefill(params, x, cfg: ModelConfig, mixer: str, cache: dict, *,
                  window=None, enc_out=None, ring=False):
    """Full-sequence forward that also fills the block's decode cache (this
    layer's slices, written in place): K/V (or MLA's latent) of the S prompt
    positions padded to capacity, ring-laid with ``ring``; the conv tail and
    the final state of ``ssm`` / ``rec``; the cross K/V of the encoder
    output.  Returns x."""
    h = apply_norm(params["norm1"], x, cfg)
    if mixer == "attn":
        h, (k, v) = attn.attention_train(params["attn"], h, cfg,
                                         window=window, return_kv=True)
        _fill(cache["k"], k, ring)
        _fill(cache["v"], v, ring)
    elif mixer == "mla":
        h, (c_kv, k_rope) = attn.mla_train(params["attn"], h, cfg,
                                           window=window, return_latent=True)
        _fill(cache["c_kv"], c_kv, ring)
        _fill(cache["k_rope"], k_rope, ring)
    elif mixer == "ssm":
        h, (conv_tail, s_final) = ssm_mod.ssm_train(params["ssm"], h, cfg,
                                                    return_state=True)
        cache["conv"].copy_(conv_tail)
        cache["ssm"].copy_(s_final)
        return x + h
    elif mixer == "rec":
        h, (conv_tail, h_last) = rglru_mod.rglru_train(params["rec"], h, cfg,
                                                       return_state=True)
        cache["conv"].copy_(conv_tail)
        cache["h"].copy_(h_last)
    x = x + h
    if enc_out is not None and "cross" in params:
        hx = apply_norm(params["norm_x"], x, cfg)
        enc_kv = attn.encode_kv(params["cross"], enc_out, cfg)
        x = x + attn.cross_attention(params["cross"], hx, enc_kv, cfg)
        cache["cross_k"].copy_(enc_kv[0])
        cache["cross_v"].copy_(enc_kv[1])
    return _ffn(params, x, cfg)[0]


def block_decode(params, x, cfg: ModelConfig, mixer: str, cache: dict, *,
                 window=None, enc_kv=None, ring=False):
    """One-token decode through a block; this layer's ``cache`` (with the
    cursor ``len``) is written in place.  Returns (x, cache)."""
    h = apply_norm(params["norm1"], x, cfg)
    if mixer == "attn":
        h, cache = attn.attention_decode(params["attn"], h, cfg, cache,
                                         window=window, ring=ring)
    elif mixer == "mla":
        h, cache = attn.mla_decode(params["attn"], h, cfg, cache,
                                   window=window)
    elif mixer == "ssm":
        h, cache = ssm_mod.ssm_decode(params["ssm"], h, cfg, cache)
        return x + h, cache
    elif mixer == "rec":
        h, cache = rglru_mod.rglru_decode(params["rec"], h, cfg, cache)
    x = x + h
    if enc_kv is not None and "cross" in params:
        h = apply_norm(params["norm_x"], x, cfg)
        x = x + attn.cross_attention(params["cross"], h, enc_kv, cfg)
    return _ffn(params, x, cfg)[0], cache
