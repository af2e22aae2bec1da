"""Plain oracles of the kernels, straight from their definitions.

Counterpart of ``repro.kernels.ref``.  Each kernel's plain version
(``*_plain`` beside it) follows the kernel's arithmetic; these follow the
definition instead (a matmul, a softmax, the pairwise pattern match), as the
reference's oracles do, and are what the tests hold both against.
``gam_retrieve_ref`` is the O(k^2) pattern oracle of the fused retrieval
kernel: it never reads a posting list, a bitset or a block union.
"""
from __future__ import annotations

import torch

from repro_torch.core.retrieval import topk_desc
from repro_torch.core.tessellation import ternary_pattern, tess_vector

__all__ = ["decode_attention_ref", "flash_prefill_ref", "gam_coarse_ref",
           "gam_retrieve_ref", "gam_score_ref", "tess_project_ref"]

_NEG = -1e30


def _f32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, device=device).to(torch.float32)


def gam_score_ref(u, v, mask) -> torch.Tensor:
    return torch.where(torch.as_tensor(mask) != 0, _f32(u) @ _f32(v).T, _NEG)


def gam_retrieve_ref(users, factors, q_tau, q_mask, item_tau, item_mask,
                     kappa: int, *, min_overlap: int = 1, spill=None,
                     alive=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Dense oracle of the fused retrieval kernel, from the patterns.

    Overlap is the pairwise destination match restricted to non-zero slots;
    candidates are ``overlap >= min_overlap`` or spill-listed, intersected
    with ``alive``.  Returns (vals, rows int32) under (score desc, row asc)
    with the kernel's empty-slot contract: (-1e30, -1) where no candidate
    fills the slot."""
    users = _f32(users)
    dev = users.device
    factors = _f32(factors, dev)
    eq = (torch.as_tensor(q_tau, device=dev)[:, None, :, None]
          == torch.as_tensor(item_tau, device=dev)[None, :, None, :])
    eq &= torch.as_tensor(q_mask, device=dev).to(torch.bool)[:, None, :, None]
    eq &= torch.as_tensor(item_mask, device=dev).to(torch.bool)[
        None, :, None, :]
    cand = eq.sum((-2, -1)) >= min_overlap                  # (Q, N)
    if spill is not None:
        cand |= torch.as_tensor(spill, device=dev).to(torch.bool)[None, :]
    if alive is not None:
        cand &= torch.as_tensor(alive, device=dev).to(torch.bool)[None, :]
    vals, rows = topk_desc(torch.where(cand, users @ factors.T, _NEG), kappa)
    return vals, torch.where(vals <= _NEG / 2, -1, rows).to(torch.int32)


def decode_attention_ref(q, k, v, length) -> torch.Tensor:
    """q: (B, Hkv, G, hd); k/v: (B, S, Hkv, hd); positions <= length."""
    hd = q.shape[-1]
    s = torch.einsum("bkgd,bskd->bkgs", q.float(), k.float()) * hd ** -0.5
    pos = torch.arange(k.shape[1], device=q.device)
    s = torch.where(pos[None, None, None, :] <= length, s, _NEG)
    out = torch.einsum("bkgs,bskd->bkgd", torch.softmax(s, dim=-1), v.float())
    return out.to(q.dtype)


def tess_project_ref(z) -> tuple[torch.Tensor, torch.Tensor]:
    return ternary_pattern(z), tess_vector(z).to(torch.float32)


def gam_coarse_ref(h, patterns, inv_sqrt_nnz) -> torch.Tensor:
    return (h.float() @ patterns.float()) * inv_sqrt_nnz[None, :]


def flash_prefill_ref(q, k, v) -> torch.Tensor:
    """q: (B, S, Hkv, G, hd); k/v: (B, S, Hkv, hd); causal."""
    hd, sq = q.shape[-1], q.shape[1]
    s = torch.einsum("bqkgd,bskd->bqkgs", q.float(), k.float()) * hd ** -0.5
    causal = torch.tril(torch.ones((sq, sq), dtype=torch.bool,
                                   device=q.device))
    s = torch.where(causal[None, :, None, None, :], s, _NEG)
    out = torch.einsum("bqkgs,bskd->bqkgd", torch.softmax(s, dim=-1),
                       v.float())
    return out.to(q.dtype)
