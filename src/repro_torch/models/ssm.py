"""Mamba-2 block (SSD, state-space duality, arXiv:2405.21060) in PyTorch.

Counterpart of ``repro.models.ssm``.  Train/prefill runs the chunked SSD
algorithm: attention-like products inside chunks of length Q and a scan
carrying the (H, P, N) state across chunks (a Python loop over the chunks
where the reference scans).  Decode is a constant-time state update, with
the state cache in f32 whatever the model's dtype.

Layout: x (B, L, H, P) with H = d_inner / head_dim heads; B/C (B, L, G, N).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import dense_init

__all__ = ["ssm_init", "ssm_train", "ssm_decode", "init_ssm_cache"]


def _conv_channels(cfg: ModelConfig) -> int:
    return cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state


def ssm_init(gen: torch.Generator, cfg: ModelConfig, dtype,
             layers: int) -> dict:
    d, di = cfg.d_model, cfg.d_inner
    g, n, h = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    conv_ch = _conv_channels(cfg)
    dev = gen.device

    def full(shape, value, dt):
        return torch.full((layers,) + shape, value, dtype=dt, device=dev)

    return {
        "in_proj": dense_init(gen, layers, (d, 2 * di + 2 * g * n + h),
                              dtype),
        "conv_w": dense_init(gen, layers, (cfg.conv_kernel, conv_ch), dtype,
                             scale=cfg.conv_kernel ** -0.5),
        "conv_b": full((conv_ch,), 0.0, dtype),
        "a_log": full((h,), 0.0, torch.float32),       # A = -exp(a_log) = -1
        "d_skip": full((h,), 1.0, torch.float32),
        "dt_bias": full((h,), 0.0, torch.float32),
        "norm": full((di,), 1.0, dtype),
        "out_proj": dense_init(gen, layers, (di, d), dtype),
    }


def _split_in_proj(params, u, cfg: ModelConfig):
    di, g, n, h = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    zxbcdt = u @ params["in_proj"]
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:di + di + 2 * g * n]
    dt = zxbcdt[..., -h:]
    return z, xbc, dt


def _gated_out(params, y, z, cfg: ModelConfig):
    """Gated RMS norm of y (f32) by SiLU(z), then the output projection."""
    yz = y * F.silu(z.float())
    yz = yz * torch.rsqrt((yz * yz).mean(-1, keepdim=True) + 1e-6)
    yz = yz * params["norm"].float()
    return yz.to(z.dtype) @ params["out_proj"]


def _causal_conv(params, xbc, cfg: ModelConfig):
    """Depthwise causal conv1d of kernel K over (B, L, C), then SiLU."""
    k, length = cfg.conv_kernel, xbc.shape[1]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    out = sum(pad[:, i:i + length, :] * params["conv_w"][i]
              for i in range(k))
    return F.silu(out + params["conv_b"])


def _ssd_chunked(x, dt, a, b_mat, c_mat, cfg: ModelConfig, s0=None):
    """Chunked SSD.  x (B,L,H,P), dt (B,L,H), a (H,), b/c (B,L,G,N), all
    f32.  Chunks of ``q = min(ssm_chunk, L)``; the whole sequence is one
    chunk when q does not divide L.  Returns (y (B,L,H,P), final state
    (B,H,P,N))."""
    bsz, length, h, p = x.shape
    g, n = cfg.ssm_groups, cfg.ssm_state
    q = min(cfg.ssm_chunk, length)
    if length % q:
        q = length
    nc = length // q
    hpg = h // g

    xr = x.reshape(bsz, nc, q, h, p)
    dtr = dt.reshape(bsz, nc, q, h)
    br = b_mat.reshape(bsz, nc, q, g, n)
    cr = c_mat.reshape(bsz, nc, q, g, n)

    dta = dtr * a                                        # (B,nc,Q,H)
    cum = torch.cumsum(dta, dim=2)
    # intra-chunk: scores[i,j] = (C_i.B_j) exp(cum_i - cum_j) dt_j, j <= i;
    # above the diagonal exp overflows, so select (a product with a tril
    # mask would give inf * 0 = NaN)
    cb = torch.einsum("bcqgn,bcsgn->bcqsg", cr, br)      # (B,nc,Q,Q,G)
    cb = torch.repeat_interleave(cb, hpg, dim=-1)        # (B,nc,Q,Q,H)
    decay = torch.exp(cum[:, :, :, None, :] - cum[:, :, None, :, :])
    tril = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    scores = torch.where(tril[None, None, :, :, None],
                         cb * decay * dtr[:, :, None, :, :], 0.0)
    y_intra = torch.einsum("bcqsh,bcshp->bcqhp", scores, xr)

    # per-chunk outgoing state: S_c = sum_j exp(cum_Q - cum_j) dt_j B_j x_j
    w = torch.exp(cum[:, :, -1:, :] - cum) * dtr         # (B,nc,Q,H)
    b_heads = torch.repeat_interleave(br, hpg, dim=3)    # (B,nc,Q,H,N)
    s_local = torch.einsum("bcqh,bcqhn,bcqhp->bchpn", w, b_heads, xr)

    # inter-chunk scan: the state entering each chunk
    chunk_decay = torch.exp(dta.sum(dim=2))              # (B,nc,H)
    s = (torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device)
         if s0 is None else s0.float())
    s_prevs = []
    for c in range(nc):
        s_prevs.append(s)
        s = s * chunk_decay[:, c, :, None, None] + s_local[:, c]
    s_prevs = torch.stack(s_prevs, dim=1)                # (B,nc,H,P,N)

    c_heads = torch.repeat_interleave(cr, hpg, dim=3)    # (B,nc,Q,H,N)
    y_inter = torch.einsum("bcqhn,bchpn->bcqhp",
                           c_heads * torch.exp(cum)[..., None], s_prevs)
    y = (y_intra + y_inter).reshape(bsz, length, h, p)
    return y, s


def ssm_train(params, u, cfg: ModelConfig, *, return_state=False):
    """Full-sequence Mamba-2 block.  u: (B, L, d) -> (B, L, d); with
    ``return_state`` also (the last K-1 pre-conv inputs, the final state)."""
    bsz, length, _ = u.shape
    di, g, n, h, p = (cfg.d_inner, cfg.ssm_groups, cfg.ssm_state,
                      cfg.ssm_heads, cfg.ssm_head_dim)
    z, xbc_raw, dt = _split_in_proj(params, u, cfg)
    xbc = _causal_conv(params, xbc_raw, cfg)
    x = xbc[..., :di].reshape(bsz, length, h, p)
    b_mat = xbc[..., di:di + g * n].reshape(bsz, length, g, n)
    c_mat = xbc[..., di + g * n:].reshape(bsz, length, g, n)
    dt = F.softplus(dt.float() + params["dt_bias"])
    a = -torch.exp(params["a_log"])
    y, s_final = _ssd_chunked(x.float(), dt, a, b_mat.float(),
                              c_mat.float(), cfg)
    y = y + x.float() * params["d_skip"][:, None]
    out = _gated_out(params, y.reshape(bsz, length, di), z, cfg)
    if return_state:
        return out, (xbc_raw[:, -(cfg.conv_kernel - 1):, :], s_final)
    return out


def init_ssm_cache(cfg: ModelConfig, batch: int, dtype, device) -> dict:
    n = cfg.n_layers
    h, p, ns = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    return {
        "conv": torch.zeros((n, batch, cfg.conv_kernel - 1,
                             _conv_channels(cfg)), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((n, batch, h, p, ns), dtype=torch.float32,
                           device=device),
        "len": torch.zeros((), dtype=torch.int32, device=device),
    }


def ssm_decode(params, u, cfg: ModelConfig, layer_cache: dict):
    """One-token decode.  u: (B, 1, d); cache conv (B, K-1, C), ssm
    (B, H, P, N), both written in place.  Returns (out, layer_cache)."""
    bsz = u.shape[0]
    di, g, n, h, p = (cfg.d_inner, cfg.ssm_groups, cfg.ssm_state,
                      cfg.ssm_heads, cfg.ssm_head_dim)
    z, xbc_new, dt = _split_in_proj(params, u, cfg)     # (B, 1, *)
    window = torch.cat([layer_cache["conv"], xbc_new], dim=1)   # (B, K, C)
    conv_out = torch.einsum("bkc,kc->bc", window, params["conv_w"])
    xbc = F.silu(conv_out + params["conv_b"])            # (B, C)
    x = xbc[:, :di].reshape(bsz, h, p)
    b_mat = xbc[:, di:di + g * n].reshape(bsz, g, n)
    c_mat = xbc[:, di + g * n:].reshape(bsz, g, n)
    dt1 = F.softplus(dt[:, 0].float() + params["dt_bias"])
    a = -torch.exp(params["a_log"])
    da = torch.exp(dt1 * a)                              # (B, H)
    hpg = h // g
    b_heads = torch.repeat_interleave(b_mat, hpg, dim=1).float()  # (B,H,N)
    c_heads = torch.repeat_interleave(c_mat, hpg, dim=1).float()
    s = layer_cache["ssm"] * da[:, :, None, None] + torch.einsum(
        "bh,bhp,bhn->bhpn", dt1, x.float(), b_heads)
    y = torch.einsum("bhpn,bhn->bhp", s, c_heads)
    y = y + x.float() * params["d_skip"][:, None]
    out = _gated_out(params, y.reshape(bsz, 1, di), z, cfg)
    layer_cache["conv"].copy_(window[:, 1:, :])
    layer_cache["ssm"].copy_(s)
    return out, layer_cache
