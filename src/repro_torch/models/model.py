"""The dense-family Model: init / forward / prefill / decode_step.

Counterpart of ``repro.models.model.Model`` for the ``dense`` family
(tinyllama-1.1b, qwen2-1.5b, olmo-1b, deepseek-67b: GQA or MHA, QKV bias,
tied or untied embeddings, rms / ln / ln_nonparam norms).  Other families
and MLA raise, naming the ROADMAP item that brings them.

Parameter tree (the reference's, leaves are tensors):
  embed       (V_padded, d)
  blocks      stacked block params, leading (L,) axis
  final_norm
  lm_head     (d, V_padded) unless cfg.tie_embeddings

The cache is ``{"k", "v": (L, B, capacity, Hkv, hd), "len": () int32}`` on
the model's device.  ``decode_step`` writes the new K/V rows into the cache
it is given and returns it with ``len`` advanced; the cursor never leaves
the device, so a step makes no host synchronisation.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models.layers import (apply_norm, norm_init, torch_dtype,
                                       truncated_normal)
from repro_torch.models.transformer import (block_decode, block_prefill,
                                            block_train, check_supported,
                                            layer_params, stack_init)

__all__ = ["Model"]


class Model:
    def __init__(self, cfg: ModelConfig, device=None):
        check_supported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = torch_dtype(cfg)

    # ------------------------------------------------------------ init

    def init(self, seed: int = 0) -> dict:
        """Random weights at the reference's scales, drawn from a
        ``torch.Generator`` on the model's device seeded with ``seed``."""
        cfg, dt = self.cfg, self.dtype
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        params: dict = {
            "embed": truncated_normal(gen, (cfg.vocab_padded, cfg.d_model),
                                      0.02, dt),
            "final_norm": norm_init(cfg, dt, self.device),
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = truncated_normal(
                gen, (cfg.d_model, cfg.vocab_padded), cfg.d_model ** -0.5, dt)
        params["blocks"] = stack_init(gen, cfg, cfg.n_layers, dt)
        return params

    # ------------------------------------------------------------ forward

    def _tokens(self, batch) -> torch.Tensor:
        return torch.as_tensor(batch["tokens"], device=self.device).long()

    def _logits(self, params, x: torch.Tensor) -> torch.Tensor:
        """x @ unembedding in the model dtype, then f32; columns >= vocab of
        the padded vocab are masked to -1e30."""
        cfg = self.cfg
        w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
        logits = (x @ w.to(x.dtype)).float()
        if cfg.vocab_padded != cfg.vocab:
            col = torch.arange(cfg.vocab_padded, device=x.device)
            logits = torch.where(col < cfg.vocab, logits, -1e30)
        return logits

    def forward(self, params, batch) -> tuple[torch.Tensor, torch.Tensor]:
        """Full-sequence logits (B, S, V_padded) f32 and the aux loss (0)."""
        cfg = self.cfg
        x = params["embed"][self._tokens(batch)]
        for i in range(cfg.n_layers):
            x = block_train(layer_params(params["blocks"], i), x, cfg)
        x = apply_norm(params["final_norm"], x, cfg)
        return (self._logits(params, x),
                torch.zeros((), dtype=torch.float32, device=x.device))

    # ------------------------------------------------------------ cache

    def init_cache(self, batch: int, capacity: int) -> dict:
        return attn_mod.init_kv_cache(self.cfg, batch, capacity, self.dtype,
                                      self.device)

    def prefill(self, params, batch, capacity: int):
        """Run the prompt and build the decode cache.  Returns
        (logits of the last position (B, 1, V_padded), cache)."""
        cfg = self.cfg
        tokens = self._tokens(batch)
        b, s = tokens.shape
        if s > capacity:
            raise ValueError(f"prompt of {s} tokens exceeds capacity {capacity}")
        cache = self.init_cache(b, capacity)
        x = params["embed"][tokens]
        for i in range(cfg.n_layers):
            x = block_prefill(layer_params(params["blocks"], i), x, cfg,
                              cache["k"][i], cache["v"][i])
        cache["len"].fill_(s)
        x = apply_norm(params["final_norm"], x, cfg)
        return self._logits(params, x[:, -1:, :]), cache

    # ------------------------------------------------------------ decode

    def decode_step(self, params, cache, tokens, *, return_hidden=False):
        """One token for every sequence.  tokens: (B, 1).  Returns (logits
        (B, 1, V_padded), cache) or, with ``return_hidden=True``, (hidden
        (B, 1, d), cache) for the GAM head.  The cache is updated in place."""
        cfg = self.cfg
        x = params["embed"][torch.as_tensor(tokens, device=self.device).long()]
        cur = cache["len"]
        for i in range(cfg.n_layers):
            lc = {"k": cache["k"][i], "v": cache["v"][i], "len": cur}
            x, _ = block_decode(layer_params(params["blocks"], i), x, cfg, lc)
        new_cache = {"k": cache["k"], "v": cache["v"], "len": cur + 1}
        x = apply_norm(params["final_norm"], x, cfg)
        if return_hidden:
            return x, new_cache
        return self._logits(params, x), new_cache
