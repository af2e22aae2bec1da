"""Public kernel entry points, dispatched on the tensor's device.

A CPU tensor goes to the kernel's plain PyTorch version; a CUDA tensor goes
to the hand-written kernel, or the call raises.  There is no fallback from
the kernel to the plain version.  Counterpart of ``repro.kernels.ops``.
"""
from __future__ import annotations

from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import flash_prefill as _fp
from repro_torch.kernels import gam_coarse as _gc
from repro_torch.kernels import gam_retrieve as _gr
from repro_torch.kernels import gam_score as _gs
from repro_torch.kernels import tess_project as _tp

__all__ = ["decode_attention", "flash_prefill", "gam_coarse", "gam_retrieve",
           "gam_score", "tess_project"]


def _on_cpu(t) -> bool:
    return t.device.type == "cpu"


def gam_score(u, v, mask):
    """where(mask, u @ v.T, NEG) as (Q, N) f32."""
    if _on_cpu(u):
        return _gs.gam_score_plain(u, v, mask)
    return _gs.gam_score(u, v, mask)


def gam_retrieve(users, factors, q_tau, q_mask, meta, kappa, *,
                 rerank_factor: int = 4, **kw):
    """Fused candidate-pruned top-kappa (the serving hot loop).

    With ``meta.quantize == "int8"`` the int8 kernel keeps a pool of
    ``kappa * rerank_factor`` rows (at least kappa, at most n_pad), which is
    re-ranked against the exact f32 ``factors`` rows."""
    if meta.quantize != "int8":
        if _on_cpu(users):
            return _gr.gam_retrieve_plain(users, factors, q_tau, q_mask, meta,
                                          kappa, **kw)
        return _gr.gam_retrieve(users, factors, q_tau, q_mask, meta, kappa,
                                **kw)
    if factors.shape[0] != meta.n_rows:
        raise ValueError(f"factors rows {factors.shape[0]} != meta.n_rows "
                         f"{meta.n_rows}")
    kappa = int(kappa)
    pool = max(kappa, min(kappa * max(1, int(rerank_factor)), meta.n_pad))
    if _on_cpu(users):
        pool_res = _gr.gam_retrieve_q_plain(users, q_tau, q_mask, meta, pool,
                                            **kw)
    else:
        pool_res = _gr.gam_retrieve_q(users, q_tau, q_mask, meta, pool, **kw)
    return _gr.rerank_pool(pool_res, users, factors, kappa)


def tess_project(z):
    """Algorithm 2 per row: (pattern int8, a f32)."""
    if _on_cpu(z):
        return _tp.tess_project_plain(z)
    return _tp.tess_project(z)


def decode_attention(q, k, v, length):
    """One-token GQA attention over positions <= length: (B, Hkv, G, hd)."""
    if _on_cpu(q):
        return _da.decode_attention_plain(q, k, v, length)
    return _da.decode_attention(q, k, v, length)


def gam_coarse(h, patterns, inv_sqrt_nnz):
    """(h (B, d) @ patterns (d, V) int8) * inv_sqrt_nnz (V,) as (B, V) f32."""
    if _on_cpu(h):
        return _gc.gam_coarse_plain(h, patterns, inv_sqrt_nnz)
    return _gc.gam_coarse(h, patterns, inv_sqrt_nnz)


def flash_prefill(q, k, v):
    """Causal GQA attention: q (B, S, Hkv, G, hd), k/v (B, S, Hkv, hd) ->
    shaped and typed like q."""
    if _on_cpu(q):
        return _fp.flash_prefill_plain(q, k, v)
    return _fp.flash_prefill(q, k, v)
