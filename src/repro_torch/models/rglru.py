"""RecurrentGemma building blocks (arXiv:2402.19427) in PyTorch: the RG-LRU
recurrent block and its gated temporal-mixing wrapper.

Counterpart of ``repro.models.rglru``.  Recurrence:

    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

with a_t = exp(-c softplus(Lambda) sigmoid(W_a x_t)), c = 8.  Train /
prefill evaluates it with a log-depth scan over the whole (B, L, W) tensor
(``_linear_scan``: the reference's associative ``combine``, doubling the
span each round, about log2 L rounds of a few element-wise launches each,
where a loop over positions would make L of them); decode is one step.  The
temporal block: two linear branches, a causal conv1d (kernel 4) and the
RG-LRU on one, a tanh-approximate GELU gate on the other.  The state cache
``h`` is f32 whatever the model's dtype.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import dense_init, gelu_tanh

__all__ = ["rglru_init", "rglru_train", "rglru_decode", "init_rglru_cache"]

_C = 8.0


def rglru_init(gen: torch.Generator, cfg: ModelConfig, dtype,
               layers: int) -> dict:
    d = cfg.d_model
    w = cfg.lru_width or d
    dev = gen.device
    # Lambda so that a^c spans [0.9, 0.999] (the paper's init range)
    lam = torch.linspace(0.9, 0.999, w, dtype=torch.float32, device=dev)
    lam_param = torch.log(torch.expm1(-torch.log(lam) / _C))  # softplus^-1

    def zeros(dt):
        return torch.zeros((layers, w), dtype=dt, device=dev)

    return {
        "in_x": dense_init(gen, layers, (d, w), dtype),
        "in_gate": dense_init(gen, layers, (d, w), dtype),
        "conv_w": dense_init(gen, layers, (cfg.conv_kernel, w), dtype,
                             scale=cfg.conv_kernel ** -0.5),
        "conv_b": zeros(dtype),
        "w_a": dense_init(gen, layers, (w, w), dtype),
        "b_a": zeros(torch.float32),
        "w_i": dense_init(gen, layers, (w, w), dtype),
        "b_i": zeros(torch.float32),
        "lam": lam_param.expand(layers, w).clone(),
        "out": dense_init(gen, layers, (w, d), dtype),
    }


def _gates(params, x):
    """log a_t and the input gate i_t (f32) of x (..., W) after the conv."""
    ra = torch.sigmoid((x @ params["w_a"]).float() + params["b_a"])
    ri = torch.sigmoid((x @ params["w_i"]).float() + params["b_i"])
    log_a = -_C * F.softplus(params["lam"]) * ra        # (..., W), < 0
    return log_a, ri


def _conv(params, x, cfg: ModelConfig):
    k, length = cfg.conv_kernel, x.shape[1]
    pad = F.pad(x, (0, 0, k - 1, 0))
    return sum(pad[:, i:i + length, :] * params["conv_w"][i]
               for i in range(k)) + params["conv_b"]


def _linear_scan(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + v_t along axis 1 from h_{-1} = 0, by doubling:
    after the round of span s each position holds the composition of the
    2s positions ending at it, with the reference's combine
    ((a_l, v_l), (a_r, v_r)) -> (a_l a_r, v_l a_r + v_r).  The grouping of
    the products differs from XLA's tree in the last bits."""
    length, span = a.shape[1], 1
    while span < length:
        a_r, v_r = a[:, span:], v[:, span:]
        v = torch.cat([v[:, :span], v[:, :-span] * a_r + v_r], dim=1)
        a = torch.cat([a[:, :span], a[:, :-span] * a_r], dim=1)
        span *= 2
    return v


def rglru_train(params, u, cfg: ModelConfig, *, return_state=False):
    """Full-sequence recurrent block.  u: (B, L, d) -> (B, L, d); with
    ``return_state`` also (the last K-1 pre-conv inputs, h at the last
    position)."""
    x_raw = u @ params["in_x"]
    x = _conv(params, x_raw, cfg)                           # (B, L, W)
    gate = gelu_tanh((u @ params["in_gate"]).float())
    log_a, ri = _gates(params, x)
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    h = _linear_scan(a, beta * ri * x.float())
    out = (h * gate).to(u.dtype) @ params["out"]
    if return_state:
        return out, (x_raw[:, -(cfg.conv_kernel - 1):, :], h[:, -1, :])
    return out


def init_rglru_cache(cfg: ModelConfig, batch: int, dtype, layers: int,
                     device) -> dict:
    w = cfg.lru_width or cfg.d_model
    return {
        "conv": torch.zeros((layers, batch, cfg.conv_kernel - 1, w),
                            dtype=dtype, device=device),
        "h": torch.zeros((layers, batch, w), dtype=torch.float32,
                         device=device),
    }


def rglru_decode(params, u, cfg: ModelConfig, layer_cache: dict):
    """One-token decode.  u: (B, 1, d); cache conv (B, K-1, W), h (B, W),
    both written in place.  Returns (out, layer_cache)."""
    x_new = u @ params["in_x"]                              # (B, 1, W)
    window = torch.cat([layer_cache["conv"], x_new], dim=1)
    x = torch.einsum("bkw,kw->bw", window, params["conv_w"]) \
        + params["conv_b"]
    gate = gelu_tanh((u[:, 0] @ params["in_gate"]).float())
    log_a, ri = _gates(params, x)
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    h = a * layer_cache["h"] + beta * ri * x.float()
    out = ((h * gate).to(u.dtype) @ params["out"])[:, None, :]
    layer_cache["conv"].copy_(window[:, 1:, :])
    layer_cache["h"].copy_(h)
    return out, layer_cache
