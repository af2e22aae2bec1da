"""Optimizers in PyTorch, on dicts of tensors.

Counterpart of ``repro.training.optimizer``: AdamW with decoupled weight
decay, global-norm gradient clipping, linear-warmup + cosine-decay
schedule, and the plain SGD step the matrix-factorisation trainers use.
Where the reference maps over pytrees, these map over (nested) dicts,
lists and tuples of tensors; states have the same structure as the params.
Every step returns new tensors and leaves its inputs as they were.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

__all__ = ["AdamWConfig", "AdamWState", "adamw_init", "adamw_update",
           "cosine_schedule", "global_norm", "sgd_update"]

Tree = Any


def tree_map(fn, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` over the tensor leaves of ``tree`` (and of ``rest``, which
    share its structure), keeping the dicts, lists and tuples around them."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree: Tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


class AdamWState(NamedTuple):
    step: torch.Tensor   # () int32
    mu: Tree             # first moment, like params
    nu: Tree             # second moment, like params


def cosine_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup then cosine decay to min_lr_frac * lr (f32)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    t = (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1)
    t = torch.clamp(t, 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32 (a 0-d tensor)."""
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in tree_leaves(tree)))


def adamw_init(params: Tree) -> AdamWState:
    """Zero moments shaped (and, for DTensor params, placed) like the
    params; a () int32 step, replicated over the params' mesh."""
    zeros = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                     params)
    leaf = tree_leaves(params)[0]
    step = torch.zeros((), dtype=torch.int32, device=leaf.device)
    if hasattr(leaf, "device_mesh"):
        from torch.distributed.tensor import DTensor, Replicate
        mesh = leaf.device_mesh
        step = DTensor.from_local(step, mesh, [Replicate()] * mesh.ndim,
                                  run_check=False)
    return AdamWState(step=step, mu=zeros, nu=tree_map(torch.clone, zeros))


def _as_param(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A DTensor gradient in its parameter's placements, so the moments and
    the new parameter keep the share of the parameter's own spec."""
    if hasattr(p, "device_mesh") and g.placements != p.placements:
        return g.redistribute(p.device_mesh, p.placements)
    return g


def adamw_update(cfg: AdamWConfig, grads: Tree, state: AdamWState,
                 params: Tree) -> tuple[Tree, AdamWState, dict]:
    """One AdamW step.  Returns (new_params, new_state, metrics)."""
    grads = tree_map(_as_param, grads, params)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    grads = tree_map(lambda g: g.to(torch.float32) * scale, grads)

    step = state.step + 1
    lr = cosine_schedule(cfg, step)
    b1c = 1 - cfg.b1 ** step.to(torch.float32)
    b2c = 1 - cfg.b2 ** step.to(torch.float32)

    mu = tree_map(lambda m, g: cfg.b1 * m + (1 - cfg.b1) * g, state.mu, grads)
    nu = tree_map(lambda v, g: cfg.b2 * v + (1 - cfg.b2) * g * g, state.nu,
                  grads)

    def upd(p, m, v):
        mhat = m / b1c
        vhat = v / b2c
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * \
            p.to(torch.float32)
        return (p.to(torch.float32) - lr * delta).to(p.dtype)

    new_params = tree_map(upd, params, mu, nu)
    return new_params, AdamWState(step, mu, nu), {"grad_norm": gnorm,
                                                  "lr": lr}


def sgd_update(lr: float, grads: Tree, params: Tree) -> Tree:
    """Plain SGD (used by the matrix-factorisation trainers)."""
    return tree_map(lambda p, g: p - lr * g, params, grads)
