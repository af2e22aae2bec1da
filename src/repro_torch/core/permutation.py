"""Region-specific permutation maps (paper §4.2 + supplement B.2), in PyTorch.

Counterpart of ``repro.core.permutation``: coordinate j of a factor lands at
destination ``tau_j`` of the p-dimensional sparse embedding, as a function of
the unnormalised tessellating pattern.  Indices are 0-based and int32.
"""
from __future__ import annotations

import torch

__all__ = ["one_hot_tau", "one_hot_dim", "parse_tree_tau", "parse_tree_dim",
           "one_hot_dary_tau", "one_hot_dary_dim", "kendall_tau_distance"]


def one_hot_dim(k: int) -> int:
    return 3 * k


def one_hot_tau(pattern: torch.Tensor) -> torch.Tensor:
    """tau_j = 3j + c, c = 0/1/2 for ã^j = 1/0/-1 (§4.2.1)."""
    j = torch.arange(pattern.shape[-1], dtype=torch.int32,
                     device=pattern.device)
    c = torch.where(pattern == 1, 0, torch.where(pattern == 0, 1, 2))
    return (3 * j + c).to(torch.int32)


def parse_tree_dim(k: int) -> int:
    # max tau: ã^j = -1 at the last coordinate gives 2k^2; a trailing
    # zero-run adds at most k-1 more; +1 for the 0-based size
    return 2 * k * k + k


def parse_tree_tau(pattern: torch.Tensor) -> torch.Tensor:
    """Parse-tree counter scheme (supplement B.2, delta=1).

    With m(j) the last index <= j where ã is non-zero (-1 if none):
    tau_j = j + 1 when m = -1, else base(m) + (j - m) with
    base(m) = k*(m+1) for ã^m = 1 and k*(k+m+1) for ã^m = -1.
    """
    k = pattern.shape[-1]
    j = torch.arange(k, dtype=torch.int32, device=pattern.device)
    j = j.expand(pattern.shape)
    m = torch.cummax(torch.where(pattern != 0, j, -1), dim=-1).values
    sign_m = torch.gather(pattern.to(torch.int32), -1,
                          torch.clamp(m, min=0).long())
    base = torch.where(sign_m == 1, k * (m + 1), k * (k + m + 1))
    return torch.where(m < 0, j + 1, base + (j - m)).to(torch.int32)


def one_hot_dary_dim(k: int, d: int) -> int:
    return (2 * d + 1) * k


def one_hot_dary_tau(h: torch.Tensor, d: int) -> torch.Tensor:
    """D-ary one-hot: coordinate j's segment has 2D+1 slots, h=D -> slot 0."""
    j = torch.arange(h.shape[-1], dtype=torch.int32, device=h.device)
    return ((2 * d + 1) * j + (d - h)).to(torch.int32)


def kendall_tau_distance(tau_a: torch.Tensor,
                         tau_b: torch.Tensor) -> torch.Tensor:
    """Number of pairwise order inversions between two index maps."""
    a = tau_a[..., :, None] - tau_a[..., None, :]
    b = tau_b[..., :, None] - tau_b[..., None, :]
    inv = (torch.sign(a) * torch.sign(b)) < 0
    return inv.sum(dim=(-2, -1)) // 2
