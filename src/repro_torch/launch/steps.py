"""Step functions (train / prefill / serve) and abstract input specs.

Counterpart of ``repro.launch.steps``.  The train step runs ``Model.loss``
forward and backward under autograd (``torch.autograd.grad`` over every
parameter leaf) and then the port's ``adamw_update``; nothing is donated,
so the caller drops the old trees.  The steps take plain tensors or
DTensors placed on a device mesh by ``sharding.specs`` alike (on a mesh
the train step's metrics come back replicated).  ``input_specs`` and the
``abstract_*`` functions give meta tensors (shape and dtype, nothing
allocated), as the reference's ``jax.ShapeDtypeStruct`` stand-ins do; the
cost analysis will trace against them.  The modality frontends are stubs, as in the
reference: whisper takes mel frames (d_frontend 80), internvl2 ViT patch
embeddings (d_frontend 3,200).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models.model import Model
from repro_torch.models.spmd import is_dtensor, replicated_constants
from repro_torch.training.optimizer import (AdamWConfig, adamw_init,
                                            adamw_update, tree_leaves,
                                            tree_map)

__all__ = ["shape_adapted_config", "input_specs", "abstract_params",
           "abstract_opt_state", "abstract_cache", "make_train_step",
           "make_prefill_step", "make_serve_step", "decode_text_len"]

_META = torch.device("meta")


def shape_adapted_config(cfg: ModelConfig, shape: ShapeConfig) -> ModelConfig:
    """Per-shape architecture adaptation: dense / moe archs switch to the
    sliding-window attention variant for long_500k."""
    if shape.name == "long_500k" and cfg.family not in ("ssm", "hybrid"):
        return cfg.with_(attn_kind="sliding", window=4096)
    return cfg


def decode_text_len(cfg: ModelConfig, seq_len: int) -> int:
    """Decoder-token length for a given total sequence length."""
    if cfg.family == "encdec":
        return max(seq_len // 4, 8)     # audio frames : text tokens ~ 4:1
    if cfg.family == "vlm":
        return seq_len - cfg.n_image_tokens
    return seq_len


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=_META)


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Abstract batch for train / prefill ('tokens' has the +1 label shift
    for train), as meta tensors."""
    b, s = shape.global_batch, shape.seq_len
    extra = 1 if shape.kind == "train" else 0
    t = decode_text_len(cfg, s)
    batch = {"tokens": _spec((b, t + extra), torch.int32)}
    if cfg.family == "encdec":
        batch["frames"] = _spec((b, s, cfg.d_frontend), torch.float32)
    if cfg.family == "vlm":
        batch["image_embeds"] = _spec((b, cfg.n_image_tokens, cfg.d_frontend),
                                      torch.float32)
    return batch


def abstract_params(model: Model) -> dict:
    """The parameter tree of ``model``'s config as meta tensors."""
    return Model(model.cfg, device=_META).init(0)


def abstract_opt_state(params_spec):
    """The AdamW state of a (meta) parameter tree, on its device."""
    return adamw_init(params_spec)


def abstract_cache(model: Model, batch: int, capacity: int) -> dict:
    """The decode cache of ``model``'s config as meta tensors."""
    return Model(model.cfg, device=_META).init_cache(batch, capacity)


# ------------------------------------------------------------------ steps


def make_train_step(model: Model, opt_cfg: AdamWConfig = AdamWConfig()):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``; metrics holds loss, nll, aux, ppl, grad_norm and lr as 0-d
    tensors on the model's device."""

    def train_step(params, opt_state, batch):
        live = tree_map(lambda p: p.detach().requires_grad_(True), params)
        # on a mesh the backward meets the model's plain constants too
        with replicated_constants(is_dtensor(params["embed"])):
            loss, metrics = model.loss(live, batch)
            grads = iter(torch.autograd.grad(loss, tree_leaves(live)))
        grads = tree_map(lambda _: next(grads), params)
        with torch.no_grad():
            params, opt_state, opt_metrics = adamw_update(
                opt_cfg, grads, opt_state, params)
        metrics = dict(metrics, **opt_metrics, loss=loss)
        return params, opt_state, {k: _whole(v.detach())
                                   for k, v in metrics.items()}

    return train_step


def _whole(x: torch.Tensor) -> torch.Tensor:
    """A metric as a replicated DTensor on a mesh (a mean over a sharded
    batch is a pending sum, and reading one rank's share of it would be
    wrong); a plain tensor as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    return x.redistribute(x.device_mesh, [Replicate()] * x.device_mesh.ndim)


def make_prefill_step(model: Model, capacity: int):
    def prefill_step(params, batch):
        return model.prefill(params, batch, capacity)

    return prefill_step


def make_serve_step(model: Model):
    """One decode step: greedy next token (int32) for every sequence."""

    def serve_step(params, cache, tokens):
        logits, cache = model.decode_step(params, cache, tokens)
        return torch.argmax(logits, dim=-1).to(torch.int32), cache

    return serve_step


def _top_k(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the ``k`` largest along the last axis, ties to the lower
    index (``jax.lax.top_k``'s order; ``torch.topk`` promises none)."""
    return torch.sort(x, dim=-1, descending=True, stable=True).indices[..., :k]


def make_gam_serve_step(model: Model, *, coarse_k: int = 128,
                        budget: int = 16_384):
    """Decode step with the GAM-accelerated LM head, computed as the
    reference computes it (plain code: the reference calls no kernel here).

    Two stages replace the full (B, d) x (d, V) head product:
      1. coarse: the query's ``coarse_k`` strongest coordinates (by |h|)
         against the int8 ternary tessellation patterns of the unembedding
         rows, scaled by ``inv_sqrt_nnz``;
      2. exact: the ``budget`` best candidates' rows gathered, exact logits
         there, then the argmax.

    ``gam`` inputs: patterns (d, V) int8 (the patterns of the unembedding
    rows, transposed) and inv_sqrt_nnz (V,) f32.
    """

    def serve_step(params, gam, cache, tokens):
        hidden, cache = model.decode_step(params, cache, tokens,
                                          return_hidden=True)
        h = hidden[:, 0].float()                                # (B, d)
        cols = _top_k(h.abs(), coarse_k)                        # (B, k')
        hsub = torch.gather(h, 1, cols)                         # (B, k')
        psub = gam["patterns"][cols].float()                    # (B, k', V)
        coarse = torch.einsum("bk,bkv->bv", hsub, psub)
        coarse = coarse * gam["inv_sqrt_nnz"][None, :]
        cand = _top_k(coarse, budget)                           # (B, C)
        embed = (params["embed"] if model.cfg.tie_embeddings
                 else params["lm_head"].T)
        rows = embed[cand].float()                              # (B, C, d)
        exact = torch.einsum("bd,bcd->bc", h, rows)
        best = torch.argmax(exact, dim=-1)
        next_tokens = torch.gather(cand, 1, best[:, None])
        return next_tokens.to(torch.int32), cache

    return serve_step


def gam_head_inputs(cfg: ModelConfig) -> dict:
    """Abstract (meta) GAM-head side inputs."""
    return {"patterns": _spec((cfg.d_model, cfg.vocab), torch.int8),
            "inv_sqrt_nnz": _spec((cfg.vocab,), torch.float32)}
