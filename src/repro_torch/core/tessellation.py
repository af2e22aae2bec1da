"""Directional tessellation of the unit sphere (paper §4.1), in PyTorch.

Counterpart of ``repro.core.tessellation``:

  * Algorithm 2 (``ternary_pattern`` / ``tess_vector``): exact closest
    tessellating vector for the ternary base set {-1, 0, 1}.
  * Algorithm 3 (``dary_pattern`` / ``tess_vector_d``): eps-approximate
    closest vector for the D-ary base set.
  * The test oracles ``enumerate_gamma`` / ``exhaustive_tess_vector``: the
    tessellating set listed in f64 and the brute-force closest vector, only
    feasible at small k.

Algorithm 2's t* is an argmax over scaled running sums, so the rounding of
those sums decides near-ties.  Here the running sum is taken strictly in
rank order in f32 (one rounded add per step) and divided by ``sqrt(t+1)``;
the CUDA ``tess_project`` kernel does the same arithmetic, so the two agree
bit for bit.  The JAX reference may round differently and then disagrees
only on rows whose top two scaled sums are a near-tie.
"""
from __future__ import annotations

import itertools

import torch

__all__ = ["dary_pattern", "enumerate_gamma", "exhaustive_tess_vector",
           "ternary_pattern", "tess_vector", "tess_vector_d"]


def _sorted_abs_ranks(z: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(|z| sorted descending, rank of each coordinate in that order).

    Ties in |z| are broken by index ascending (a stable sort)."""
    az = z.abs()
    order = torch.argsort(-az, dim=-1, stable=True)
    ranks = torch.argsort(order, dim=-1, stable=True)
    return torch.gather(az, -1, order), ranks


def _scaled_cumsum(z_down: torch.Tensor) -> torch.Tensor:
    """z_s^t = (sum_{j<=t} z_down^j) / sqrt(t+1), the sum taken in order."""
    k = z_down.shape[-1]
    out = torch.empty_like(z_down)
    run = torch.zeros_like(z_down[..., 0])
    for t in range(k):
        run = run + z_down[..., t]
        out[..., t] = run / torch.sqrt(torch.tensor(t + 1, dtype=z_down.dtype,
                                                    device=z_down.device))
    return out


def ternary_pattern(z: torch.Tensor) -> torch.Tensor:
    """Unnormalised ternary tessellating vector in {-1,0,1}^k (Alg 2), int8.

    Batched over leading dimensions; the last axis is the factor dim k."""
    z_down, ranks = _sorted_abs_ranks(z)
    t_star = torch.argmax(_scaled_cumsum(z_down), dim=-1, keepdim=True)
    sign = torch.where(z >= 0, 1, -1).to(torch.int8)
    return torch.where(ranks <= t_star, sign, torch.zeros_like(sign))


def tess_vector(z: torch.Tensor) -> torch.Tensor:
    """Normalised closest tessellating vector ``a_z`` (Alg 2 step 10)."""
    pat = ternary_pattern(z).to(z.dtype)
    t = pat.abs().sum(dim=-1, keepdim=True)
    return pat / torch.sqrt(torch.clamp(t, min=1))


def dary_pattern(z: torch.Tensor, d: int) -> torch.Tensor:
    """Unnormalised D-ary tessellating vector (Alg 3): integer numerators h in
    [-D, D] (int32), ã = h / D.  An all-zero result is repaired by setting
    the max-|z| coordinate to ±1."""
    zn = z / torch.linalg.vector_norm(z, dim=-1, keepdim=True)
    h = torch.clamp(torch.round(zn * d), -d, d).to(torch.int32)
    all_zero = (h == 0).all(dim=-1, keepdim=True)
    top = torch.argmax(zn.abs(), dim=-1, keepdim=True)
    sign = torch.where(torch.gather(zn, -1, top) >= 0, 1, -1).to(torch.int32)
    fix = torch.zeros_like(h).scatter_(-1, top, sign)
    return torch.where(all_zero, fix, h)


def tess_vector_d(z: torch.Tensor, d: int) -> torch.Tensor:
    """Normalised eps-approximate closest D-ary tessellating vector (Alg 3)."""
    h = dary_pattern(z, d).to(z.dtype) / d
    return h / torch.linalg.vector_norm(h, dim=-1, keepdim=True)


def enumerate_gamma(k: int, d: int = 1) -> torch.Tensor:
    """The normalised tessellating set Gamma in f64 (test oracle): d=1 the
    ternary set (3^k - 1 rows), general d the D-ary set with base values
    {0, +-1/d, ..., +-1}."""
    base = [i / d for i in range(-d, d + 1)]
    rows = torch.tensor([v for v in itertools.product(base, repeat=k)
                         if any(x != 0 for x in v)], dtype=torch.float64)
    return rows / torch.linalg.vector_norm(rows, dim=1, keepdim=True)


def exhaustive_tess_vector(z, k: int | None = None, d: int = 1
                           ) -> torch.Tensor:
    """Brute-force argmin over Gamma of the angle to z, in f64: the oracle of
    Lemmas 1 and 2.  ``z``: (k,) or (B, k)."""
    z = torch.as_tensor(z).to(torch.float64)
    squeeze = z.dim() == 1
    if squeeze:
        z = z[None]
    gamma = enumerate_gamma(z.shape[-1], d).to(z.device)
    zn = z / torch.linalg.vector_norm(z, dim=-1, keepdim=True)
    out = gamma[torch.argmax(zn @ gamma.T, dim=-1)]
    return out[0] if squeeze else out
