"""The unified Model: init / forward / prefill / decode_step for every family.

Counterpart of ``repro.models.model.Model``: dense (GQA or MHA, QKV bias,
tied or untied embeddings, rms / ln / ln_nonparam norms), ``moe`` (routed
and shared experts; MLA attention with ``use_mla``), ``ssm`` (Mamba-2),
``hybrid`` (RecurrentGemma: period-3 groups rec, rec, local attn, plus a
tail of ``n_layers % 3`` rec blocks), ``encdec`` (whisper: an encoder stack
over stubbed frame embeddings, cross-attention in the decoder) and ``vlm``
(a projected image-embedding prefix of ``n_image_tokens``).

Parameter tree (the reference's, leaf for leaf; leaves are tensors):
  embed       (V_padded, d)
  blocks      stacked block params, leading (L,) axis; hybrid: a dict of
              three stacks (rec1, rec2, attn) over the period-3 groups
  tail        (hybrid only) the trailing rec blocks
  frontend_proj, enc_blocks, enc_norm   (encdec only)
  img_proj    (vlm only) the patch-embedding projector
  final_norm
  lm_head     (d, V_padded) unless cfg.tie_embeddings

The leaves of ``layers.F32_LEAVES`` are f32 under any ``cfg.dtype``, as in
the reference.  Caches are the reference's dicts of stacked per-layer
tensors plus a () int32 cursor ``len``, on the model's device; the hybrid's
attention cache is a ring of min(capacity, local_window) slots, whisper's
cross K/V hold the encoder's length.  ``decode_step`` writes the new rows
into the cache it is given and returns it with ``len`` advanced; the cursor
never leaves the device, so a step makes no host synchronisation.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (apply_norm, dense_init, norm_init,
                                       torch_dtype, truncated_normal)
from repro_torch.models.transformer import (block_decode, block_prefill,
                                            block_train, layer_params,
                                            mixer_for_layer, stack_init)

__all__ = ["Model"]


class Model:
    def __init__(self, cfg: ModelConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = torch_dtype(cfg)
        if cfg.family == "hybrid":
            self.n_groups, self.n_tail = divmod(cfg.n_layers, 3)

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
            params["lm_head"] = dense_init(
                gen, 1, (cfg.d_model, cfg.vocab_padded), dt)[0]
        if cfg.family == "hybrid":
            params["blocks"] = {
                name: stack_init(gen, cfg, mixer, self.n_groups, dt)
                for name, mixer in (("rec1", "rec"), ("rec2", "rec"),
                                    ("attn", "attn"))}
            if self.n_tail:
                params["tail"] = stack_init(gen, cfg, "rec", self.n_tail, dt)
        elif cfg.family == "encdec":
            params["frontend_proj"] = dense_init(
                gen, 1, (cfg.d_frontend, cfg.d_model), dt)[0]
            params["enc_blocks"] = stack_init(gen, cfg, "attn",
                                              cfg.n_encoder_layers, dt)
            params["enc_norm"] = norm_init(cfg, dt, self.device)
            params["blocks"] = stack_init(gen, cfg, "attn", cfg.n_layers, dt,
                                          cross=True)
        else:
            params["blocks"] = stack_init(gen, cfg, mixer_for_layer(cfg, 0),
                                          cfg.n_layers, dt)
            if cfg.family == "vlm":
                params["img_proj"] = dense_init(
                    gen, 1, (cfg.d_frontend, cfg.d_model), dt)[0]
        return params

    # ------------------------------------------------------------ inputs

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    def _embed(self, params, batch) -> torch.Tensor:
        """Token embeddings, behind the projected image prefix for vlm."""
        x = params["embed"][self._tensor(batch["tokens"]).long()]
        if self.cfg.family == "vlm":
            proj = params["img_proj"]
            img = self._tensor(batch["image_embeds"]).to(proj.dtype) @ proj
            x = torch.cat([img.to(x.dtype), x], dim=1)
        return x

    def n_prefix(self) -> int:
        """Positions in front of the prompt's tokens (the image tokens)."""
        return self.cfg.n_image_tokens if self.cfg.family == "vlm" else 0

    def _encode(self, params, frames) -> torch.Tensor:
        """Encoder stack (whisper): frames (B, S_enc, d_frontend)."""
        cfg = self.cfg
        proj = params["frontend_proj"]
        x = self._tensor(frames).to(proj.dtype) @ proj
        for i in range(cfg.n_encoder_layers):
            x, _ = block_train(layer_params(params["enc_blocks"], i), x, cfg,
                               "attn", causal=False)
        return apply_norm(params["enc_norm"], x, cfg)

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

    # ------------------------------------------------------------ forward

    def forward(self, params, batch) -> tuple[torch.Tensor, torch.Tensor]:
        """Full-sequence logits (B, S, V_padded) f32 (S counts the image
        prefix for vlm) and the aux loss (the MoE load-balance loss summed
        over layers, else 0).  batch: 'tokens' (B, S) and the family's
        extras ('frames', 'image_embeds')."""
        cfg = self.cfg
        aux = torch.zeros((), dtype=torch.float32, device=self.device)
        x = self._embed(params, batch)
        if cfg.family == "hybrid":
            groups = params["blocks"]
            for i in range(self.n_groups):
                for name, mixer in (("rec1", "rec"), ("rec2", "rec")):
                    x, _ = block_train(layer_params(groups[name], i), x, cfg,
                                       mixer)
                x, _ = block_train(layer_params(groups["attn"], i), x, cfg,
                                   "attn", window=cfg.local_window)
            for i in range(self.n_tail):
                x, _ = block_train(layer_params(params["tail"], i), x, cfg,
                                   "rec")
        else:
            enc_out = (self._encode(params, batch["frames"])
                       if cfg.family == "encdec" else None)
            mixer = mixer_for_layer(cfg, 0)
            for i in range(cfg.n_layers):
                x, a = block_train(layer_params(params["blocks"], i), x, cfg,
                                   mixer, enc_out=enc_out)
                aux = aux + a
        x = apply_norm(params["final_norm"], x, cfg)
        return self._logits(params, x), aux

    # ------------------------------------------------------------ cache

    def init_cache(self, batch: int, capacity: int,
                   enc_len: int | None = None) -> dict:
        """Zero cache for ``batch`` sequences of up to ``capacity``
        positions; whisper's cross K/V hold ``enc_len`` encoder positions
        (default ``capacity``, as the reference sizes them)."""
        cfg, dt, dev = self.cfg, self.dtype, self.device
        if cfg.family == "ssm":
            return ssm_mod.init_ssm_cache(cfg, batch, dt, dev)
        if cfg.family == "hybrid":
            # local attention only ever sees the trailing window: a ring
            cap_attn = min(capacity, cfg.local_window)
            kv = attn_mod.init_kv_cache(cfg, batch, cap_attn, dt, dev,
                                        layers=self.n_groups)
            cache = {
                "groups": {
                    name: rglru_mod.init_rglru_cache(cfg, batch, dt,
                                                     self.n_groups, dev)
                    for name in ("rec1", "rec2")},
                "len": kv.pop("len"),
            }
            cache["groups"]["attn"] = kv
            if self.n_tail:
                cache["tail"] = rglru_mod.init_rglru_cache(
                    cfg, batch, dt, self.n_tail, dev)
            return cache
        if cfg.use_mla:
            return attn_mod.init_mla_cache(cfg, batch, capacity, dt, dev)
        cache = attn_mod.init_kv_cache(cfg, batch, capacity, dt, dev)
        if cfg.family == "encdec":
            s_enc = capacity if enc_len is None else enc_len
            cache["cross_k"] = torch.zeros(
                (cfg.n_layers, batch, s_enc, cfg.n_kv_heads, cfg.hd),
                dtype=dt, device=dev)
            cache["cross_v"] = torch.zeros_like(cache["cross_k"])
        return cache

    # ------------------------------------------------------------ prefill

    def prefill(self, params, batch, capacity: int):
        """Run the prompt (behind the image prefix for vlm; after the encoder
        for encdec) and build the decode cache.  Returns (logits of the last
        position (B, 1, V_padded), cache).  Raises when the positions
        (image tokens included) exceed ``capacity`` of a linear KV cache."""
        cfg = self.cfg
        x = self._embed(params, batch)
        b, s = x.shape[:2]
        if cfg.family not in ("ssm", "hybrid") and s > capacity:
            raise ValueError(f"{s} prompt positions (image tokens included) "
                             f"exceed capacity {capacity}")
        if cfg.family == "hybrid":
            cache = self.init_cache(b, capacity)
            groups, gc = params["blocks"], cache["groups"]
            for i in range(self.n_groups):
                for name in ("rec1", "rec2"):
                    x = block_prefill(layer_params(groups[name], i), x, cfg,
                                      "rec", layer_params(gc[name], i))
                x = block_prefill(layer_params(groups["attn"], i), x, cfg,
                                  "attn", layer_params(gc["attn"], i),
                                  window=cfg.local_window, ring=True)
            for i in range(self.n_tail):
                x = block_prefill(layer_params(params["tail"], i), x, cfg,
                                  "rec", layer_params(cache["tail"], i))
        else:
            enc_out = None
            if cfg.family == "encdec":
                enc_out = self._encode(params, batch["frames"])
            cache = self.init_cache(
                b, capacity, None if enc_out is None else enc_out.shape[1])
            mixer = mixer_for_layer(cfg, 0)
            layers = {k: v for k, v in cache.items() if k != "len"}
            for i in range(cfg.n_layers):
                x = block_prefill(layer_params(params["blocks"], i), x, cfg,
                                  mixer, layer_params(layers, i),
                                  enc_out=enc_out)
        cache["len"].fill_(s)
        x = apply_norm(params["final_norm"], x, cfg)
        return self._logits(params, x[:, -1:, :]), cache

    # ------------------------------------------------------------ decode

    def decode_step(self, params, cache, tokens, *, return_hidden=False):
        """One token for every sequence.  tokens: (B, 1).  Returns (logits
        (B, 1, V_padded), cache) or, with ``return_hidden=True``, (hidden
        (B, 1, d), cache) for the GAM head.  The cache is updated in place;
        the returned dict holds the same tensors and ``len`` + 1."""
        cfg = self.cfg
        x = params["embed"][self._tensor(tokens).long()]
        cur = cache["len"]

        def step(x, bp, lc, mixer, **kw):
            return block_decode(bp, x, cfg, mixer, dict(lc, len=cur), **kw)[0]

        if cfg.family == "hybrid":
            groups, gc = params["blocks"], cache["groups"]
            for i in range(self.n_groups):
                for name in ("rec1", "rec2"):
                    x = step(x, layer_params(groups[name], i),
                             layer_params(gc[name], i), "rec")
                x = step(x, layer_params(groups["attn"], i),
                         layer_params(gc["attn"], i), "attn",
                         window=cfg.local_window, ring=True)
            for i in range(self.n_tail):
                x = step(x, layer_params(params["tail"], i),
                         layer_params(cache["tail"], i), "rec")
        else:
            mixer = mixer_for_layer(cfg, 0)
            layers = {k: v for k, v in cache.items() if k != "len"}
            for i in range(cfg.n_layers):
                lc = layer_params(layers, i)
                enc_kv = None
                if cfg.family == "encdec":
                    enc_kv = (lc.pop("cross_k"), lc.pop("cross_v"))
                x = step(x, layer_params(params["blocks"], i), lc, mixer,
                         enc_kv=enc_kv)
        new_cache = dict(cache, len=cur + 1)
        x = apply_norm(params["final_norm"], x, cfg)
        if return_hidden:
            return x, new_cache
        return self._logits(params, x), new_cache
