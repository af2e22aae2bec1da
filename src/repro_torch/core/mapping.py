"""The sparse map phi (paper Algorithm 1, ProcessFactors), in PyTorch.

Counterpart of ``repro.core.mapping``.  phi(z) is represented sparsely as
(indices, values) with exactly k entries: coordinate j of z lands at index
``tau_j``.  The ternary pattern comes from ``kernels.ops.tess_project``, so
on a CUDA tensor the map step runs the hand-written kernel and on a CPU
tensor its plain version.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

import torch

from repro_torch.core import permutation as perm
from repro_torch.core import tessellation as tess
from repro_torch.kernels import ops

Scheme = Literal["one_hot", "parse_tree", "one_hot_dary"]

__all__ = ["GamConfig", "sparse_map", "densify", "pattern_overlap"]


@dataclasses.dataclass(frozen=True)
class GamConfig:
    """Configuration of a geometry-aware mapping schema."""

    k: int                       # factor dimensionality
    scheme: Scheme = "parse_tree"  # the paper's experiments use parse_tree
    d: int = 1                   # D-ary base set order (1 = ternary {-1,0,1})
    threshold: float = 0.0       # optional |z| thresholding before mapping (§6)

    @property
    def p(self) -> int:
        if self.scheme == "one_hot":
            return perm.one_hot_dim(self.k)
        if self.scheme == "parse_tree":
            return perm.parse_tree_dim(self.k)
        if self.scheme == "one_hot_dary":
            return perm.one_hot_dary_dim(self.k, self.d)
        raise ValueError(self.scheme)


def sparse_map(z: torch.Tensor,
               cfg: GamConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """phi(z) as (indices, values): phi(z)[indices[j]] = values[j].

    ``z``: (..., k) f32.  Returns indices (..., k) int32 and values (..., k).
    Thresholded entries keep their destination index and carry value 0.
    """
    if z.shape[-1] != cfg.k:
        raise ValueError(f"expected factor dim {cfg.k}, got {z.shape[-1]}")
    zt = torch.where(z.abs() >= cfg.threshold, z, 0.0) if cfg.threshold else z
    if cfg.scheme in ("one_hot", "parse_tree"):
        flat = zt.reshape(-1, cfg.k).to(torch.float32).contiguous()
        pattern = ops.tess_project(flat)[0].reshape(zt.shape)
        tau = (perm.one_hot_tau(pattern) if cfg.scheme == "one_hot"
               else perm.parse_tree_tau(pattern))
    elif cfg.scheme == "one_hot_dary":
        tau = perm.one_hot_dary_tau(tess.dary_pattern(zt, cfg.d), cfg.d)
    else:
        raise ValueError(cfg.scheme)
    return tau, zt


def densify(indices: torch.Tensor, values: torch.Tensor, p: int) -> torch.Tensor:
    """Materialise the dense phi(z) in R^p (tests / small-scale only)."""
    out = torch.zeros(indices.shape[:-1] + (p,), dtype=values.dtype,
                      device=values.device)
    return out.scatter_(-1, indices.long(), values)


def pattern_overlap(tau_a: torch.Tensor, tau_b: torch.Tensor) -> torch.Tensor:
    """|sparsity-pattern intersection| between phi maps (batched, O(k^2))."""
    return (tau_a[..., :, None] == tau_b[..., None, :]).sum(dim=(-2, -1))
