"""The port's plain ``decode_attention`` against the JAX reference.

Inputs are made with numpy from a seed and handed to both packages: the
Pallas kernel in interpret mode (``bs=64``, so S = 100 and 257 are not a
multiple of its block), its oracle ``decode_attention_ref``, and the port's
``decode_attention_plain`` (also reached through ``ops.decode_attention``
on CPU tensors).

Tolerances: f32 within 2e-5 (absolute and relative), the reference suite's
own bound for the kernel against its oracle; both compute softmax(q k^T)
v in f32 in a different order.  bf16 within 3e-2: the output is rounded once
to bf16 (relative step 2^-8), and a sum rounded on either side of a bf16
boundary differs by one step.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.kernels import ref  # noqa: E402
from repro.kernels.decode_attention import decode_attention as pallas_decode  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    _mma_smem,
    _smem,
    decode_attention_plain,
    decode_splits,
)

TOL = {"float32": 2e-5, "bfloat16": 3e-2}
SHAPES = [(1, 1, 1, 32, 64), (2, 2, 4, 64, 128), (3, 1, 8, 64, 100),
          (2, 4, 2, 128, 257), (1, 2, 16, 64, 1024)]


def _inputs(b, hkv, g, hd, s, seed):
    r = np.random.default_rng(seed)
    return (r.normal(size=(b, hkv, g, hd)).astype(np.float32),
            r.normal(size=(b, s, hkv, hd)).astype(np.float32),
            r.normal(size=(b, s, hkv, hd)).astype(np.float32))


def _torch(x, dtype):
    return torch.from_numpy(x).to(getattr(torch, dtype))


@pytest.mark.parametrize("b,hkv,g,hd,s", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_reference_kernel_and_oracle(b, hkv, g, hd, s, dtype):
    q, k, v = _inputs(b, hkv, g, hd, s, b * s + hd)
    length = s - 2
    jq, jk, jv = (jnp.asarray(x, getattr(jnp, dtype)) for x in (q, k, v))
    jlen = jnp.asarray(length, jnp.int32)
    want_kernel = np.asarray(pallas_decode(jq, jk, jv, jlen, bs=64,
                                           interpret=True), np.float32)
    want_ref = np.asarray(ref.decode_attention_ref(jq, jk, jv, jlen),
                          np.float32)
    tq, tk, tv = (_torch(x, dtype) for x in (q, k, v))
    got = decode_attention_plain(tq, tk, tv, torch.tensor(length,
                                                          dtype=torch.int32))
    assert got.dtype == tq.dtype and got.shape == tq.shape
    got = got.float().numpy()
    tol = TOL[dtype]
    np.testing.assert_allclose(got, want_ref, rtol=tol, atol=tol)
    np.testing.assert_allclose(got, want_kernel, rtol=tol, atol=tol)
    via_ops = ops.decode_attention(tq, tk, tv, length).float().numpy()
    np.testing.assert_array_equal(via_ops, got)


@pytest.mark.parametrize("length", [0, 40, 95])
def test_plain_length_mask_invariance(length):
    """K/V past ``length`` never change the output, as in the reference."""
    b, hkv, g, hd, s = 2, 1, 2, 32, 96
    q, k, v = _inputs(b, hkv, g, hd, s, 7)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    out1 = decode_attention_plain(tq, tk, tv, length)
    k2, v2 = tk.clone(), tv.clone()
    k2[:, length + 1:] = 99.0
    v2[:, length + 1:] = -99.0
    out2 = decode_attention_plain(tq, k2, v2, length)
    np.testing.assert_array_equal(out1.numpy(), out2.numpy())
    jout = pallas_decode(jnp.asarray(q), jnp.asarray(k2), jnp.asarray(v2),
                         jnp.asarray(length, jnp.int32), bs=32,
                         interpret=True)
    np.testing.assert_allclose(out2.numpy(), np.asarray(jout), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("b,hkv,g,hd,s,sms,elt", [
    (8, 4, 8, 64, 1064, 132, 2), (128, 4, 8, 64, 32768, 132, 2),
    (1, 1, 1, 32, 64, 132, 4), (2, 1, 48, 256, 300, 132, 4),
    (3, 2, 6, 200, 5, 8, 2), (2, 1, 16, 256, 520, 132, 4),
    (2, 1, 48, 256, 130, 132, 2), (2, 2, 3, 8, 7, 132, 2),
    (4, 4, 8, 64, 32768, 132, 4)])
def test_kernel_grid_covers_every_position_and_head(b, hkv, g, hd, s, sms,
                                                    elt):
    """The kernel's split of S and of the query heads (host arithmetic that
    the CPU reaches): whole tiles, every position in exactly one chunk,
    every head in one block, and the shared memory within what a block may
    take.  bf16 (the tensor-core kernel): 16 heads a block, one mma row
    tile, tiles of 32 positions (16 past hd 64).  f32: tiles that divide
    the 128 threads, each block's accumulators within the 128 x 16 a CTA
    holds in registers."""
    gc, gblk, n_gblk, tile, chunk, n_split = decode_splits(b, hkv, g, hd, s,
                                                           sms, elt)
    assert tile in (16, 32, 64) and chunk % tile == 0
    assert chunk * n_split >= s and chunk * (n_split - 1) < s
    assert gblk * n_gblk >= g and gblk * (n_gblk - 1) < g
    if elt == 2:
        assert gc == 0 and gblk == min(g, 16)
        assert tile == (16 if hd > 64 else 32)
        assert _mma_smem(hd) <= 227 * 1024
        return
    assert gc in (1, 2, 4, 8) and gc < 2 * min(g, 8)
    gpad = -(-gblk // gc) * gc
    assert gc == 1 or gpad // gc >= 128 // tile    # every thread group scores
    assert gpad * hd <= 128 * 16
    assert _smem(tile, gpad, hd, elt) <= 227 * 1024
