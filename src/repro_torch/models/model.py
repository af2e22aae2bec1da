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

The train-time forward runs each decoder block, each whisper encoder
block, each RecurrentGemma period-3 group (as one unit) and each of its
tail blocks through ``transformer.remat_wrap``, so ``cfg.remat`` decides
what the backward keeps and what it recomputes, as in the reference.

Parameters, batches and caches may be DTensors placed on a device mesh
(``sharding.specs``): the methods run the same code, with the few ops
DTensor cannot place written per rank in ``models/spmd.py``; ``prefill``
then places its cache on the parameters' mesh, sharded on batch.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (apply_norm, dense_init, norm_init,
                                       torch_dtype, truncated_normal)
from repro_torch.models.spmd import (embed_on_mesh, is_dtensor, picked,
                                     replicated_constants, whole_dim)
from repro_torch.models.transformer import (block_decode, block_prefill,
                                            block_train, layer_list,
                                            layer_params, mixer_for_layer,
                                            remat_wrap, stack_init)

__all__ = ["Model"]


def _on_mesh(method):
    """Run a method of :class:`Model` so that, when its parameters are
    DTensors on a device mesh, the plain tensors it makes itself read as
    replicated (``spmd.replicated_constants``)."""
    @functools.wraps(method)
    def run(self, params, *args, **kw):
        with replicated_constants(is_dtensor(params["embed"])):
            return method(self, params, *args, **kw)
    return run


class _MetaGenerator:
    """Stands in for a ``torch.Generator`` when a model is built on the meta
    device: the initialisers read only its ``device`` there, and
    ``truncated_normal`` draws nothing into a meta tensor."""
    device = torch.device("meta")


class Model:
    def __init__(self, cfg: ModelConfig, device=None):
        """``device``: the card (``None``), ``"cpu"``, or ``"meta"``, where
        ``init`` and ``init_cache`` give shapes and dtypes only and allocate
        nothing (``launch.steps.abstract_params``)."""
        self.cfg = cfg
        self.device = (torch.device("meta") if str(device) == "meta"
                       else resolve_device(device))
        self.dtype = torch_dtype(cfg)
        if cfg.family == "hybrid":
            self.n_groups, self.n_tail = divmod(cfg.n_layers, 3)

    # ------------------------------------------------------------ init

    def init(self, seed: int = 0) -> dict:
        """Random weights at the reference's scales, drawn from a
        ``torch.Generator`` on the model's device seeded with ``seed``."""
        cfg, dt = self.cfg, self.dtype
        gen = (_MetaGenerator() if self.device.type == "meta" else
               torch.Generator(device=self.device).manual_seed(int(seed)))
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

    def _rows(self, params, tokens) -> torch.Tensor:
        """The embedding rows of ``tokens``."""
        tokens = self._tensor(tokens).long()
        if is_dtensor(params["embed"]):
            return embed_on_mesh(params["embed"], tokens)
        return params["embed"][tokens]

    def _embed(self, params, batch) -> torch.Tensor:
        """Token embeddings, behind the projected image prefix for vlm."""
        x = self._rows(params, batch["tokens"])
        if self.cfg.family == "vlm":
            proj = params["img_proj"]
            img = (self._tensor(batch["image_embeds"]).to(proj.dtype)
                   @ proj).to(x.dtype)
            if is_dtensor(x):
                # on a mesh the rows are a pending sum over the vocab split
                # and the prefix is split over features: DTensor cannot cat
                # the two, so both take the rows' layout, the sum done
                from torch.distributed.tensor import Replicate
                whole = [Replicate() if p.is_partial() else p
                         for p in x.placements]
                x = x.redistribute(x.device_mesh, whole)
                img = img.redistribute(x.device_mesh, whole)
            x = torch.cat([img, x], dim=1)
        return x

    def n_prefix(self) -> int:
        """Positions in front of the prompt's tokens (the image tokens)."""
        return self.cfg.n_image_tokens if self.cfg.family == "vlm" else 0

    def _encode(self, params, frames) -> torch.Tensor:
        """Encoder stack (whisper): frames (B, S_enc, d_frontend)."""
        cfg = self.cfg
        proj = params["frontend_proj"]
        x = self._tensor(frames).to(proj.dtype) @ proj
        body = remat_wrap(functools.partial(block_train, cfg=cfg,
                                            mixer="attn", causal=False), cfg)
        for lp in layer_list(params["enc_blocks"], cfg.n_encoder_layers):
            x, _ = body(lp, x)
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

    def _group_train(self, group, x) -> torch.Tensor:
        """A RecurrentGemma period-3 group, full sequence: rec, rec, local
        attention."""
        cfg = self.cfg
        for name in ("rec1", "rec2"):
            x, _ = block_train(group[name], x, cfg, "rec")
        x, _ = block_train(group["attn"], x, cfg, "attn",
                           window=cfg.local_window)
        return x

    @_on_mesh
    def forward(self, params, batch) -> tuple[torch.Tensor, torch.Tensor]:
        """Full-sequence logits (B, S, V_padded) f32 (S counts the image
        prefix for vlm) and the aux loss (the MoE load-balance loss summed
        over layers, else 0).  batch: 'tokens' (B, S) and the family's
        extras ('frames', 'image_embeds')."""
        cfg = self.cfg
        aux = torch.zeros((), dtype=torch.float32, device=self.device)
        x = self._embed(params, batch)
        if cfg.family == "hybrid":
            # a period-3 group is one rematerialised unit, as in the
            # reference; each tail block is one
            group_body = remat_wrap(self._group_train, cfg)
            for group in layer_list(params["blocks"], self.n_groups):
                x = group_body(group, x)
            tail_body = remat_wrap(functools.partial(
                block_train, cfg=cfg, mixer="rec"), cfg)
            for lp in (layer_list(params["tail"], self.n_tail)
                       if self.n_tail else []):
                x, _ = tail_body(lp, x)
        else:
            enc_out = (self._encode(params, batch["frames"])
                       if cfg.family == "encdec" else None)
            body = remat_wrap(functools.partial(
                block_train, cfg=cfg, mixer=mixer_for_layer(cfg, 0)), cfg)
            for lp in layer_list(params["blocks"], cfg.n_layers):
                x, a = body(lp, x, enc_out=enc_out)
                aux = aux + a
        x = apply_norm(params["final_norm"], x, cfg)
        return self._logits(params, x), aux

    @_on_mesh
    def shifted_logits(self, params, batch):
        """batch['tokens']: (B, S+1) -> (logits (B, S, V_padded) of inputs
        tokens[:, :-1] at the text positions (the image prefix dropped),
        labels tokens[:, 1:], aux loss)."""
        tokens = self._tensor(batch["tokens"]).long()
        logits, aux = self.forward(params, dict(batch, tokens=tokens[:, :-1]))
        return logits[:, self.n_prefix():, :], tokens[:, 1:], aux

    @_on_mesh
    def loss(self, params, batch) -> tuple[torch.Tensor, dict]:
        """Mean next-token nll over ``shifted_logits``.  Returns (nll + 0.01
        aux, {"nll", "aux", "ppl" = exp(min(nll, 20))})."""
        logits, labels, aux = self.shifted_logits(params, batch)
        logp = torch.log_softmax(logits, dim=-1)
        nll = -picked(logp, labels).mean()
        return nll + 0.01 * aux, {"nll": nll, "aux": aux,
                                  "ppl": torch.exp(torch.clamp(nll, max=20.0))}

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

    def _cache_for(self, params, batch: int, capacity: int,
                   enc_len: int | None = None) -> dict:
        """A zero cache; with DTensor parameters, placed on their mesh by
        ``cache_specs`` (sharded on batch), each rank holding its block."""
        cache = self.init_cache(batch, capacity, enc_len)
        if not is_dtensor(params["embed"]):
            return cache
        from repro_torch.sharding.specs import cache_specs, place
        mesh = params["embed"].device_mesh
        return place(cache, cache_specs(self.cfg, mesh, cache,
                                        seq_shard=False))

    # ------------------------------------------------------------ prefill

    @_on_mesh
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
            cache = self._cache_for(params, b, capacity)
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
            cache = self._cache_for(
                params, b, capacity,
                None if enc_out is None else enc_out.shape[1])
            mixer = mixer_for_layer(cfg, 0)
            layers = {k: v for k, v in cache.items() if k != "len"}
            for i in range(cfg.n_layers):
                x = block_prefill(layer_params(params["blocks"], i), x, cfg,
                                  mixer, layer_params(layers, i),
                                  enc_out=enc_out)
        cache["len"].fill_(s)
        x = apply_norm(params["final_norm"], x, cfg)
        return whole_dim(self._logits(params, x[:, -1:, :]), -1), cache

    # ------------------------------------------------------------ decode

    @_on_mesh
    def decode_step(self, params, cache, tokens, *, return_hidden=False):
        """One token for every sequence.  tokens: (B, 1).  Returns (logits
        (B, 1, V_padded), cache) or, with ``return_hidden=True``, (hidden
        (B, 1, d), cache) for the GAM head.  The cache is updated in place;
        the returned dict holds the same tensors and ``len`` + 1."""
        cfg = self.cfg
        x = self._rows(params, tokens)
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
        return whole_dim(self._logits(params, x), -1), new_cache
