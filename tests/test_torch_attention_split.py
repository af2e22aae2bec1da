"""The arithmetic of the port's bf16 tensor-core attention kernels, on the CPU.

``flash_prefill.cu`` and ``decode_attention.cu`` compute q.k on bf16 ``mma``
with f32 sums, and p.v as three bf16 ``mma`` on the exact split of the f32
probability p into ``p_hi + p_mid + p_lo`` (``csrc/attn_mma.cuh``).  The
kernels cannot run here, so this file checks what they rely on:

- the split is exact for p in [2^-100, 1] and each term is a bf16 number;
  below 2^-100 (f32 subnormals included) it drops less than 2^-120;
- a torch emulation of the kernels' arithmetic (bf16 q.k products with f32
  sums, online softmax over tiles, p.v as three bf16-term products with f32
  sums, partial states merged as the kernels merge them) agrees with the JAX
  reference (``repro.kernels.flash_prefill`` / ``decode_attention`` in
  interpret mode, and ``kernels/ref.py``) within one bf16 step: rtol 2^-7
  over an atol of 1e-5, since both compute in f32 from the same bf16 inputs
  and round once.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")
hypothesis = pytest.importorskip("hypothesis")
st = pytest.importorskip("hypothesis.strategies")

from repro.kernels import ref  # noqa: E402
from repro.kernels.decode_attention import decode_attention as jax_decode  # noqa: E402
from repro.kernels.flash_prefill import flash_prefill as jax_flash  # noqa: E402

RTOL, ATOL = 2.0 ** -7, 1e-5          # one bf16 step over a floor


def split3(p: torch.Tensor):
    """The kernels' split of f32 ``p``: (p_hi, p_mid, p_lo), each a bf16
    number held in f32 (``attn::split3``)."""
    hi = p.to(torch.bfloat16).float()
    r = p - hi                                        # exact
    mid = r.to(torch.bfloat16).float()
    lo = (r - mid).to(torch.bfloat16).float()
    return hi, mid, lo


def _is_bf16(x: torch.Tensor) -> bool:
    return torch.equal(x.to(torch.bfloat16).float(), x)


def _check_exact(p: np.ndarray) -> None:
    t = torch.from_numpy(p.astype(np.float32))
    hi, mid, lo = split3(t)
    assert _is_bf16(hi) and _is_bf16(mid) and _is_bf16(lo)
    total = hi.double() + mid.double() + lo.double()   # exact in f64
    np.testing.assert_array_equal(total.numpy(), t.double().numpy())


@hypothesis.settings(deadline=None, max_examples=200)
@hypothesis.given(st.lists(st.floats(min_value=2.0 ** -100, max_value=1.0,
                                     width=32), min_size=1, max_size=64))
@hypothesis.example([1.0])
@hypothesis.example([float(np.nextafter(np.float32(0.5), np.float32(0)))])
@hypothesis.example([2.0 ** -100])
def test_split_is_exact_for_probabilities(ps):
    _check_exact(np.asarray(ps, np.float32))


@pytest.mark.parametrize("e", [0, -1, -7, -8, -9, -16, -24, -25, -60, -99,
                               -100])
def test_split_is_exact_just_under_and_at_powers_of_two(e):
    """p = 2^e, the f32 numbers just under it (all 24 significand bits
    set), and random p in [2^(e-1), 2^e)."""
    top = np.float32(2.0 ** e)
    below = np.nextafter(top, np.float32(0))
    rnd = np.random.default_rng(-e).uniform(0.5, 1.0, 256) * 2.0 ** e
    p = np.concatenate([[top, below, np.nextafter(below, np.float32(0))],
                        rnd.astype(np.float32)])
    _check_exact(p[(p >= 2.0 ** -100) & (p <= 1.0)])


@hypothesis.settings(deadline=None, max_examples=200)
@hypothesis.given(st.lists(st.floats(min_value=0.0, max_value=2.0 ** -100,
                                     width=32, allow_subnormal=True),
                           min_size=1, max_size=64))
@hypothesis.example([float(np.float32(1e-45))])       # smallest subnormal
@hypothesis.example([float(np.finfo(np.float32).tiny)])
def test_split_drops_under_2_to_minus_120_below_2_to_minus_100(ps):
    t = torch.tensor(ps, dtype=torch.float32)
    hi, mid, lo = split3(t)
    assert _is_bf16(hi) and _is_bf16(mid) and _is_bf16(lo)
    err = (hi.double() + mid.double() + lo.double() - t.double()).abs()
    assert float(err.max()) < 2.0 ** -120


# ------------------------------------------------ emulation of the kernels


def _walk(q, k, v, keep, tile, walkers, base2=False):
    """Online softmax of rows q (R, hd) over keys k/v (N, hd), ``keep`` (R,
    N): tiles of ``tile`` keys dealt to ``walkers`` in turn (the decode
    kernel's warps; one for prefill), each with its own (m, l, acc), masked
    scores -inf.  q.k in f32 from bf16 values; p.v as three products on
    split3(p); ``base2``: scores scaled by log2(e) and p = 2^(s - m), as the
    prefill kernel takes them.  Returns each walker's (m, l, acc)."""
    scale = q.shape[1] ** -0.5
    exp = torch.exp
    if base2:
        scale = float(torch.tensor(scale) * torch.tensor(1.4426950408889634))
        exp = torch.exp2
    states = []
    n = k.shape[0]
    for w in range(walkers):
        m = torch.full((q.shape[0],), -torch.inf)
        l = torch.zeros(q.shape[0])
        acc = torch.zeros(q.shape[0], v.shape[1])
        for t0 in range(w * tile, n, walkers * tile):
            s = (q @ k[t0:t0 + tile].T) * scale
            s = torch.where(keep[:, t0:t0 + tile], s, -torch.inf)
            m_new = torch.maximum(m, s.amax(1))
            m_safe = torch.where(m_new == -torch.inf, 0.0, m_new)
            p = exp(s - m_safe[:, None])
            corr = exp(m - m_safe)
            l = l * corr + p.sum(1)
            vt = v[t0:t0 + tile]
            acc = acc * corr[:, None] + sum(x @ vt for x in split3(p))
            m = m_new
        states.append((m, l, acc))
    return states


def _merge(states):
    """(m, l, acc) of several walkers -> one, as the kernels merge them."""
    m = torch.stack([s[0] for s in states]).amax(0)
    l = torch.zeros_like(states[0][1])
    acc = torch.zeros_like(states[0][2])
    for ms, ls, accs in states:
        c = torch.where(ms == -torch.inf, 0.0,
                        torch.exp(ms - torch.where(m == -torch.inf, 0.0, m)))
        l = l + ls * c
        acc = acc + accs * c[:, None]
    return m, l, acc


def emulate_prefill(q, k, v):
    """flash_prefill_mma_kernel's arithmetic: q (B, S, Hkv, G, hd), k/v
    (B, S, Hkv, hd) bf16 -> causal attention, bf16."""
    b, s, hkv, g, hd = q.shape
    out = torch.empty(q.shape)
    pos = torch.arange(s)
    keep = (pos[None, :] <= pos[:, None]).repeat_interleave(g, 0)
    for bi in range(b):
        for h in range(hkv):
            rows = q[bi, :, h].reshape(s * g, hd).float()
            _, l, acc = _walk(rows, k[bi, :, h].float(), v[bi, :, h].float(),
                              keep, 64, 1, base2=True)[0]
            out[bi, :, h] = (acc / l.clamp(min=1e-30)[:, None]).reshape(
                s, g, hd)
    return out.to(torch.bfloat16)


def emulate_decode(q, k, v, length, chunk, tile=32, warps=4):
    """decode_mma_kernel + decode_merge_kernel: q (B, Hkv, G, hd), k/v (B, S,
    Hkv, hd) bf16, positions <= length; S cut into chunks, each walked by
    ``warps`` warps taking tiles in turn, the warps then the chunks
    merged."""
    b, hkv, g, hd = q.shape
    s = k.shape[1]
    out = torch.empty(q.shape)
    for bi in range(b):
        for h in range(hkv):
            parts = []
            for c0 in range(0, s, chunk):
                end = min(s, c0 + chunk, length + 1)
                if end <= c0:
                    continue
                keep = torch.ones((g, end - c0), dtype=torch.bool)
                parts.append(_merge(_walk(
                    q[bi, h].float(), k[bi, c0:end, h].float(),
                    v[bi, c0:end, h].float(), keep, tile, warps)))
            _, l, acc = _merge(parts)
            out[bi, h] = acc / l[:, None]
    return out.to(torch.bfloat16)


def _bf16_inputs(shapes, seed):
    r = np.random.default_rng(seed)
    return [r.normal(size=sh).astype(np.float32) for sh in shapes]


def _close(got, want):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want,
                                                               np.float32),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("b,s,hkv,g,hd", [
    (1, 64, 1, 1, 32), (2, 100, 2, 3, 48), (1, 13, 1, 8, 64),
    (1, 150, 1, 8, 64), (1, 70, 2, 2, 16)])
def test_prefill_emulation_matches_reference(b, s, hkv, g, hd):
    x = _bf16_inputs([(b, s, hkv, g, hd), (b, s, hkv, hd), (b, s, hkv, hd)],
                     b * s + g + hd)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in x)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in x)
    got = emulate_prefill(tq, tk, tv)
    _close(got, ref.flash_prefill_ref(jq, jk, jv))
    _close(got, jax_flash(jq, jk, jv, interpret=True))


@pytest.mark.parametrize("b,hkv,g,hd,s,chunk,length", [
    (2, 2, 4, 64, 128, 64, 127), (1, 1, 8, 64, 300, 128, 200),
    (2, 1, 16, 128, 257, 96, 256), (1, 2, 3, 48, 100, 32, 40),
    (1, 1, 6, 100, 333, 160, 330), (1, 1, 8, 64, 1064, 64, 1054)])
def test_decode_emulation_matches_reference(b, hkv, g, hd, s, chunk, length):
    x = _bf16_inputs([(b, hkv, g, hd), (b, s, hkv, hd), (b, s, hkv, hd)],
                     b * s + g + hd)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in x)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in x)
    tile = 16 if hd > 64 else 32
    got = emulate_decode(tq, tk, tv, length, chunk, tile)
    jlen = jnp.asarray(length, jnp.int32)
    _close(got, ref.decode_attention_ref(jq, jk, jv, jlen))
    _close(got, jax_decode(jq, jk, jv, jlen, bs=64, interpret=True))
