"""Pre-norm residual blocks of the dense family and their stacked init.

Counterpart of the ``attn`` mixer with the SwiGLU MLP in
``repro.models.transformer``.  Parameters are stacked over layers, as the
reference's ``vmap``-ed init leaves them: ``stack_init`` returns one tree
whose leaves carry a leading (L,) axis, and a block runs on the layer slice
``layer_params(blocks, i)`` (views, no copies).  The other mixers (MLA,
SSM, RG-LRU), MoE and cross-attention come with later slices.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import (apply_norm, norm_init, swiglu,
                                       truncated_normal)

__all__ = ["block_train", "block_prefill", "block_decode", "stack_init",
           "layer_params", "check_supported"]


def check_supported(cfg: ModelConfig) -> None:
    """Raise for a configuration this slice of the port does not serve."""
    if cfg.family != "dense" or cfg.use_mla:
        what = "MLA attention" if cfg.use_mla else f"the {cfg.family!r} family"
        raise NotImplementedError(
            f"{cfg.arch_id}: the port serves the dense family (GQA/MHA "
            f"attention + SwiGLU); {what} comes with a later slice (ROADMAP "
            f"queue 1, item 8: MoE, MLA, SSM, hybrid, encdec, VLM)")


def stack_init(gen: torch.Generator, cfg: ModelConfig, layers: int,
               dtype) -> dict:
    """Stacked (layers, ...) parameters of the attn + SwiGLU block."""
    d, f = cfg.d_model, cfg.d_ff
    dev = gen.device
    return {
        "norm1": norm_init(cfg, dtype, dev, (layers,)),
        "attn": attn.attn_init(gen, cfg, dtype, layers),
        "norm2": norm_init(cfg, dtype, dev, (layers,)),
        "mlp": {"gate": truncated_normal(gen, (layers, d, f), d ** -0.5, dtype),
                "up": truncated_normal(gen, (layers, d, f), d ** -0.5, dtype),
                "down": truncated_normal(gen, (layers, f, d), f ** -0.5,
                                         dtype)},
    }


def layer_params(tree, i: int):
    """The i-th layer of a stacked parameter tree (views)."""
    if isinstance(tree, dict):
        return {k: layer_params(v, i) for k, v in tree.items()}
    return tree[i]


def block_train(params, x, cfg: ModelConfig):
    """Pre-norm residual block, full sequence.  Returns x."""
    h = apply_norm(params["norm1"], x, cfg)
    x = x + attn.attention_train(params["attn"], h, cfg)
    return x + swiglu(params["mlp"], apply_norm(params["norm2"], x, cfg))


def block_prefill(params, x, cfg: ModelConfig, k_cache: torch.Tensor,
                  v_cache: torch.Tensor):
    """Full-sequence forward that also fills the block's decode cache: K/V
    of the S prompt positions go to slots [0, S) of ``k_cache``/``v_cache``
    (B, capacity, Hkv, hd), the rest stay zero (the reference's padding to
    ``capacity``).  Returns x."""
    s = x.shape[1]
    h = apply_norm(params["norm1"], x, cfg)
    h, (k, v) = attn.attention_train(params["attn"], h, cfg, return_kv=True)
    k_cache[:, :s] = k
    v_cache[:, :s] = v
    x = x + h
    return x + swiglu(params["mlp"], apply_norm(params["norm2"], x, cfg))


def block_decode(params, x, cfg: ModelConfig, cache: dict):
    """One-token decode through a block; ``cache`` (k, v, len) is written in
    place.  Returns (x, cache)."""
    h = apply_norm(params["norm1"], x, cfg)
    h, cache = attn.attention_decode(params["attn"], h, cfg, cache)
    x = x + h
    return x + swiglu(params["mlp"], apply_norm(params["norm2"], x, cfg)), cache
