"""The sparse map phi of the configuration, frozen: ternary tessellation
(Algorithm 2) and the parse-tree permutation (supplement B.2), in plain
PyTorch on the CPU.

An independent copy of the arithmetic the configuration states: the
thresholded factor, |z| sorted descending with ties by index ascending, the
running sum taken in rank order with one rounded add a step and divided by
sqrt(t + 1), the first argmax as t*.  In ``"f32"`` every step is IEEE f32
(on the CPU, or on a card, where PyTorch's division and square root are
correctly rounded too); ``"bf16"`` (the control) runs the same steps in
bfloat16.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["DTYPES", "parse_tree_dim", "phi", "posting_lengths"]

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
_CHUNK = 1 << 18          # rows a step, to bound the temporaries


def parse_tree_dim(k: int) -> int:
    """p: the largest destination 2k^2 + (k - 1), plus one."""
    return 2 * k * k + k


def _pattern(z: torch.Tensor) -> torch.Tensor:
    """Ternary pattern in {-1, 0, 1} (int8) of each row of ``z``."""
    az = z.abs()
    order = torch.argsort(-az, dim=-1, stable=True)
    ranks = torch.argsort(order, dim=-1, stable=True)
    z_down = torch.gather(az, -1, order).T.contiguous()       # (k, n)
    k = z.shape[-1]
    scaled = torch.empty_like(z_down)
    run = torch.zeros_like(z_down[0])
    for t in range(k):
        run = run + z_down[t]
        scaled[t] = run / torch.sqrt(torch.tensor(t + 1, dtype=z.dtype,
                                                  device=z.device))
    t_star = torch.argmax(scaled.T, dim=-1, keepdim=True)
    sign = torch.where(z >= 0, 1, -1).to(torch.int8)
    return torch.where(ranks <= t_star, sign, torch.zeros_like(sign))


def _parse_tree_tau(pattern: torch.Tensor) -> torch.Tensor:
    """tau_j = j + 1 before the first non-zero; else base(m) + (j - m), with
    m the last non-zero index <= j, base = k(m + 1) for +1 and k(k + m + 1)
    for -1."""
    k = pattern.shape[-1]
    j = torch.arange(k, dtype=torch.int64,
                     device=pattern.device).expand(pattern.shape)
    m = torch.cummax(torch.where(pattern != 0, j, -1), dim=-1).values
    sign_m = torch.gather(pattern.to(torch.int64), -1, torch.clamp(m, min=0))
    base = torch.where(sign_m == 1, k * (m + 1), k * (k + m + 1))
    return torch.where(m < 0, j + 1, base + (j - m))


def phi(z: np.ndarray, threshold: float, scheme: str = "parse_tree",
        precision: str = "f32", device="cpu") -> tuple[np.ndarray, np.ndarray]:
    """(n, k) factors -> (tau (n, k) int64 destinations, mask (n, k) bool of
    the non-zero coordinates of phi(z)), worked out on ``device``."""
    if scheme != "parse_tree":
        raise ValueError(f"the frozen reference maps parse_tree only, "
                         f"not {scheme!r}")
    dtype = DTYPES[precision]
    z = np.asarray(z, np.float32)
    taus, masks = [], []
    for lo in range(0, max(len(z), 1), _CHUNK):
        zt = torch.from_numpy(z[lo:lo + _CHUNK]).to(device=device,
                                                     dtype=dtype)
        if threshold:
            zt = torch.where(zt.abs() >= torch.tensor(threshold, dtype=dtype,
                                                      device=device),
                             zt, torch.zeros((), dtype=dtype, device=device))
        taus.append(_parse_tree_tau(_pattern(zt)).cpu().numpy())
        masks.append((zt != 0).cpu().numpy())
    return np.concatenate(taus), np.concatenate(masks)


def posting_lengths(tau: np.ndarray, mask: np.ndarray, p: int) -> np.ndarray:
    """(p,) entries of each destination's posting list."""
    return np.bincount(tau[mask], minlength=p)
