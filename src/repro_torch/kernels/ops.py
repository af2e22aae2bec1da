"""Public kernel entry points, dispatched on the tensor's device.

A CPU tensor goes to the kernel's plain PyTorch version; a CUDA tensor goes
to the hand-written kernel, or the call raises.  There is no fallback from
the kernel to the plain version.  Counterpart of ``repro.kernels.ops``.
"""
from __future__ import annotations

from repro_torch.kernels import gam_retrieve as _gr
from repro_torch.kernels import gam_score as _gs
from repro_torch.kernels import tess_project as _tp

__all__ = ["gam_retrieve", "gam_score", "tess_project"]


def _on_cpu(t) -> bool:
    return t.device.type == "cpu"


def gam_score(u, v, mask):
    """where(mask, u @ v.T, NEG) as (Q, N) f32."""
    if _on_cpu(u):
        return _gs.gam_score_plain(u, v, mask)
    return _gs.gam_score(u, v, mask)


def gam_retrieve(users, factors, q_tau, q_mask, meta, kappa, **kw):
    """Fused candidate-pruned top-kappa (the serving hot loop)."""
    if _on_cpu(users):
        return _gr.gam_retrieve_plain(users, factors, q_tau, q_mask, meta,
                                      kappa, **kw)
    return _gr.gam_retrieve(users, factors, q_tau, q_mask, meta, kappa, **kw)


def tess_project(z):
    """Algorithm 2 per row: (pattern int8, a f32)."""
    if _on_cpu(z):
        return _tp.tess_project_plain(z)
    return _tp.tess_project(z)
