"""Mixture-of-experts FFN with top-k routing, in PyTorch.

Counterpart of ``repro.models.moe``.  Dispatch is sort-based with a
per-expert capacity (GShard / Switch): the (token, slot) pairs are ranked
within their expert by one stable argsort of the f32 key ``expert * 2 -
gate / max(gate)``, pairs past ``capacity = int(max(1, capacity_factor * T
* K / E))`` are dropped, and the experts run as batched matmuls over (E,
C, d) tiles.  Every step is the reference's, so the same pairs are kept and
dropped:

- top-k breaks ties on the lower expert index (a stable descending sort,
  as ``lax.top_k``; ``torch.topk`` promises no order);
- the sort key is the reference's f32 key, not a tuple sort: near-equal
  gates of one expert tie in f32 and fall to pair order;
- the router is f32 whatever the model's dtype.

Sums that the card would otherwise make with atomics are fixed in order:
a tile slot receives at most one pair (the dropped pairs all write zeros to
one spare row), and each token's K expert outputs are added one by one in
ascending expert order, the order of the reference's scatter-add over the
sorted pairs.  So bf16 results are the same from run to run.

DeepSeek's shared experts (always on) and the Switch load-balance loss are
included.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import dense_init, swiglu, swiglu_init

__all__ = ["moe_init", "moe_ffn", "route", "Routing"]

# bytes of one (experts, capacity, width) tile of the expert matmuls: wider
# tiles are computed a block of experts at a time (same results, bounded
# memory; a dropless capacity at full width would otherwise take tens of GB)
_TILE_BYTES = 1 << 31


def moe_init(gen: torch.Generator, cfg: ModelConfig, dtype,
             layers: int) -> dict:
    d = cfg.d_model
    ffe = cfg.d_ff_expert or cfg.d_ff
    e = cfg.n_experts
    s_in, s_out = d ** -0.5, ffe ** -0.5
    p = {
        "router": dense_init(gen, layers, (d, e), torch.float32, scale=s_in),
        "gate": dense_init(gen, layers, (e, d, ffe), dtype, scale=s_in),
        "up": dense_init(gen, layers, (e, d, ffe), dtype, scale=s_in),
        "down": dense_init(gen, layers, (e, ffe, d), dtype, scale=s_out),
    }
    if cfg.n_shared_experts:
        p["shared"] = swiglu_init(gen, layers, d, cfg.n_shared_experts * ffe,
                                  dtype)
    return p


@dataclasses.dataclass
class Routing:
    """Where each (token, slot) pair goes.  ``expert``/``gate``: (T, K) in
    slot order (gate desc, expert asc on ties); ``order``: (T K,) the pairs
    sorted by (expert, rank); ``slot``: (T K,) each sorted pair's row of the
    flattened (E, C) tile, ``E C`` (the spare row) where ``keep`` is False;
    ``aux``: the Switch loss; ``capacity``: C."""
    expert: torch.Tensor
    gate: torch.Tensor
    order: torch.Tensor
    slot: torch.Tensor
    keep: torch.Tensor
    aux: torch.Tensor
    capacity: int


def route(params: dict, xt: torch.Tensor, cfg: ModelConfig) -> Routing:
    """Top-k routing of the tokens xt (T, d) with the capacity rank."""
    t = xt.shape[0]
    e, k = cfg.n_experts, cfg.moe_top_k
    logits = xt.float() @ params["router"]                      # (T, E) f32
    probs = torch.softmax(logits, dim=-1)
    # stable descending sort: equal probabilities keep the lower index first
    gate_vals, expert_idx = torch.sort(probs, dim=-1, descending=True,
                                       stable=True)
    gate_vals, expert_idx = gate_vals[:, :k], expert_idx[:, :k]
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True)

    # Switch aux loss: E * sum_e f_e * p_e
    me = probs.mean(dim=0)
    ce = torch.bincount(expert_idx.reshape(-1), minlength=e).float() / (t * k)
    aux = e * (me * ce).sum()

    capacity = int(max(1, cfg.capacity_factor * t * k / e))
    flat_expert = expert_idx.reshape(-1)
    flat_gate = gate_vals.reshape(-1)
    # rank each pair within its expert: the reference's f32 key, stably
    sort_key = flat_expert.float() * 2.0 - flat_gate / (flat_gate.max() + 1e-9)
    order = torch.argsort(sort_key, stable=True)
    se = flat_expert[order]
    idx = torch.arange(t * k, device=xt.device)
    is_start = torch.ones_like(se, dtype=torch.bool)
    is_start[1:] = se[1:] != se[:-1]
    seg_start = torch.cummax(torch.where(is_start, idx, -1), dim=0).values
    pos_in_expert = idx - seg_start
    keep = pos_in_expert < capacity
    slot = torch.where(keep, se * capacity + pos_in_expert, e * capacity)
    return Routing(expert_idx, gate_vals, order, slot, keep, aux, capacity)


def _experts(params: dict, dispatch: torch.Tensor) -> torch.Tensor:
    """SwiGLU of each expert on its (C, d) tile: (E, C, d) -> (E, C, d),
    a block of experts at a time when the tile is large."""
    e, c, d = dispatch.shape
    ffe = params["gate"].shape[-1]
    per_expert = c * max(d, ffe) * dispatch.element_size()
    step = max(1, _TILE_BYTES // per_expert)
    out = torch.empty_like(dispatch)
    for lo in range(0, e, step):
        hi = min(e, lo + step)
        x = dispatch[lo:hi]
        h = F.silu(torch.bmm(x, params["gate"][lo:hi])) \
            * torch.bmm(x, params["up"][lo:hi])
        out[lo:hi] = torch.bmm(h, params["down"][lo:hi])
    return out


def moe_ffn(params: dict, x: torch.Tensor, cfg: ModelConfig):
    """x: (B, S, d) -> (out (B, S, d), aux loss)."""
    b, s, d = x.shape
    t = b * s
    e, k = cfg.n_experts, cfg.moe_top_k
    xt = x.reshape(t, d)
    r = route(params, xt, cfg)
    c = r.capacity
    st = torch.div(r.order, k, rounding_mode="floor")            # token
    sg = r.gate.reshape(-1)[r.order]

    # scatter the kept pairs into (E, C, d) tiles; every dropped pair
    # writes zeros to the spare row E C, so no slot sees two values
    rows = torch.where(r.keep[:, None], xt[st], 0).to(x.dtype)
    dispatch = torch.zeros((e * c + 1, d), dtype=x.dtype, device=x.device)
    dispatch.index_copy_(0, r.slot, rows)
    ho = _experts(params, dispatch[:-1].reshape(e, c, d)).reshape(e * c, d)

    # gather back with the gate weights, each pair to its (token, slot)
    gathered = ho[torch.where(r.keep, r.slot, 0)]
    contrib = torch.where(r.keep[:, None],
                          gathered * sg[:, None].to(x.dtype), 0)
    by_pair = torch.empty_like(contrib)
    by_pair[r.order] = contrib
    by_pair = by_pair.reshape(t, k, d)
    # add each token's K outputs in ascending expert order, one at a time
    by_expert = torch.argsort(r.expert, dim=1)
    by_pair = torch.gather(by_pair, 1, by_expert[:, :, None].expand(t, k, d))
    out = by_pair[:, 0]
    for j in range(1, k):
        out = out + by_pair[:, j]

    if cfg.n_shared_experts:
        out = out + swiglu(params["shared"], xt)
    return out.reshape(b, s, d), r.aux
