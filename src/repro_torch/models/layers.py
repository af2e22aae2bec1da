"""Shared neural layers: norms, rotary embeddings, the SwiGLU MLP, GELU, init.

Counterpart of ``repro.models.layers``.  Weights keep the reference's
layout, ``(in, out)`` applied as ``x @ w``, so a parameter tree crosses
between the packages unchanged (``models/convert.py``).  Initialisers draw
from an explicit ``torch.Generator`` with the reference's scales; the numbers
differ from ``jax.random``'s, so parity tests hand both packages the same
weights instead.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig

__all__ = ["norm_init", "apply_norm", "rope", "swiglu", "swiglu_init",
           "truncated_normal", "dense_init", "gelu_tanh", "torch_dtype",
           "leaf_dtype", "F32_LEAVES"]

# leaves the reference keeps in f32 whatever ``cfg.dtype`` says: the MoE
# router (a bf16 router would pick other experts), the SSM's A, D and dt
# bias, and the RG-LRU's gate biases and Lambda
F32_LEAVES = frozenset({"router", "a_log", "d_skip", "dt_bias", "b_a", "b_i",
                        "lam"})


_DRAW = 1 << 26


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg.dtype]


def leaf_dtype(name: str, cfg: ModelConfig) -> torch.dtype:
    """The dtype of the parameter leaf called ``name``: f32 for
    ``F32_LEAVES``, else the config's."""
    return torch.float32 if name in F32_LEAVES else torch_dtype(cfg)


def truncated_normal(gen: torch.Generator, shape, scale: float,
                     dtype: torch.dtype) -> torch.Tensor:
    """``scale`` x a standard normal truncated to [-2, 2], by the inverse
    CDF (as ``jax.random.truncated_normal`` draws it), on ``gen``'s device.
    Drawn ``_DRAW`` elements at a time, so the f32 temporaries stay small
    beside a multi-GB weight."""
    lo, hi = (1.0 + math.erf(-2.0 / math.sqrt(2.0))) / 2.0, \
        (1.0 + math.erf(2.0 / math.sqrt(2.0))) / 2.0
    out = torch.empty(tuple(shape), dtype=dtype, device=gen.device)
    if out.is_meta:                 # shapes only: nothing to draw
        return out
    flat = out.view(-1)
    for i in range(0, flat.numel(), _DRAW):
        u = torch.rand(min(_DRAW, flat.numel() - i), generator=gen,
                       device=gen.device, dtype=torch.float32)
        x = math.sqrt(2.0) * torch.erfinv(2.0 * (lo + (hi - lo) * u) - 1.0)
        flat[i:i + u.numel()] = scale * x.clamp_(-2.0, 2.0)
    return out


def dense_init(gen: torch.Generator, layers: int, shape, dtype,
               scale: float | None = None) -> torch.Tensor:
    """A stacked (layers, *shape) weight, truncated normal at the
    reference's scale (``shape[0] ** -0.5`` unless given)."""
    scale = shape[0] ** -0.5 if scale is None else scale
    return truncated_normal(gen, (layers,) + tuple(shape), scale, dtype)


# ------------------------------------------------------------------ norms


def norm_init(cfg: ModelConfig, dtype, device, layers: tuple = ()) -> dict:
    """Norm parameters, with leading ``layers`` axes for a stack."""
    shape = tuple(layers) + (cfg.d_model,)
    if cfg.norm == "rms":
        return {"scale": torch.ones(shape, dtype=dtype, device=device)}
    if cfg.norm == "ln":
        return {"scale": torch.ones(shape, dtype=dtype, device=device),
                "bias": torch.zeros(shape, dtype=dtype, device=device)}
    if cfg.norm == "ln_nonparam":   # OLMo: non-parametric LayerNorm
        return {}
    raise ValueError(cfg.norm)


def apply_norm(params: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """RMSNorm or LayerNorm in f32 with eps 1e-6, cast back to x's dtype."""
    xf = x.float()
    if cfg.norm == "rms":
        xf = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + 1e-6)
        return (xf * params["scale"].float()).to(x.dtype)
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    xf = (xf - mu) * torch.rsqrt(var + 1e-6)
    if cfg.norm == "ln":
        xf = xf * params["scale"].float() + params["bias"].float()
    return xf.to(x.dtype)


# ------------------------------------------------------------------ rope


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding on INTERLEAVED pairs (x[..., 0::2], x[..., 1::2]),
    as the reference rotates them.  x: (..., S, H, hd) or (..., S, hd);
    positions (..., S)."""
    hd = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                          device=x.device) / hd))
    ang = positions.float()[..., None] * freqs               # (..., S, hd/2)
    if x.dim() == ang.dim() + 1:                             # head axis
        ang = ang[..., None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., 0::2].float(), x[..., 1::2].float()
    out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


# ------------------------------------------------------------------ mlp


def swiglu_init(gen: torch.Generator, layers: int, d: int, f: int,
                dtype) -> dict:
    return {"gate": dense_init(gen, layers, (d, f), dtype),
            "up": dense_init(gen, layers, (d, f), dtype),
            "down": dense_init(gen, layers, (f, d), dtype)}


def swiglu(params: dict, x: torch.Tensor) -> torch.Tensor:
    g = F.silu(x @ params["gate"])
    return (g * (x @ params["up"])) @ params["down"]


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation (torch's default
    GELU is the erf form)."""
    return F.gelu(x, approximate="tanh")
