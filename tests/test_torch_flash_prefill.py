"""The port's ``flash_prefill`` against ``repro``'s, on the CPU.

The plain version (what the port's ``ops.flash_prefill`` runs on a CPU
tensor) is held against the JAX Pallas kernel in interpret mode and against
``kernels.ref.flash_prefill_ref``, at the shapes of
``tests/test_kernels.py`` in f32 and bf16 with the reference's own
tolerances (2e-5 f32, 4e-2 bf16: the two packages sum the dot products and
the softmax in different orders, and bf16 outputs round once), plus a
sequence length that is not a multiple of 32 and the causality check.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.kernels import ref  # noqa: E402
from repro.kernels.flash_prefill import flash_prefill as jax_flash  # noqa: E402
from repro_torch.kernels import flash_prefill as fp  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

SHAPES = [(1, 64, 1, 1, 32), (2, 128, 2, 4, 64), (1, 96, 1, 8, 64),
          (2, 256, 4, 2, 32)]
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 4e-2)}


def _inputs(b, s, hkv, g, hd, seed):
    r = np.random.default_rng(seed)
    return (r.normal(size=(b, s, hkv, g, hd)).astype(np.float32),
            r.normal(size=(b, s, hkv, hd)).astype(np.float32),
            r.normal(size=(b, s, hkv, hd)).astype(np.float32))


def _both(q, k, v, dtype, *, bq=32, bk=32):
    jd, td, tol = DTYPES[dtype]
    jq, jk, jv = (jnp.asarray(x, jd) for x in (q, k, v))
    got = ops.flash_prefill(*(torch.from_numpy(x).to(td) for x in (q, k, v)))
    assert got.dtype == td and tuple(got.shape) == q.shape
    want = jax_flash(jq, jk, jv, bq=bq, bk=bk, interpret=True)
    oracle = ref.flash_prefill_ref(jq, jk, jv)
    return (got.float().numpy(), np.asarray(want, np.float32),
            np.asarray(oracle, np.float32), tol)


@pytest.mark.parametrize("b,s,hkv,g,hd", SHAPES + [(1, 100, 2, 3, 48)])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plain_flash_prefill_matches_reference(b, s, hkv, g, hd, dtype):
    got, want, oracle, tol = _both(*_inputs(b, s, hkv, g, hd, b * s + hd + g),
                                   dtype)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    np.testing.assert_allclose(got, oracle, rtol=tol, atol=tol)


def test_plain_flash_prefill_is_causal():
    """Poisoning the future must not change the earlier positions' outputs,
    in the port as in the reference."""
    q, k, v = _inputs(1, 64, 1, 2, 32, 11)
    out1 = ops.flash_prefill(*(torch.from_numpy(x) for x in (q, k, v)))
    k2, v2 = k.copy(), v.copy()
    k2[:, 40:] = 77.0
    v2[:, 40:] = -77.0
    out2 = ops.flash_prefill(*(torch.from_numpy(x) for x in (q, k2, v2)))
    np.testing.assert_allclose(out1[:, :40].numpy(), out2[:, :40].numpy(),
                               atol=1e-6)
    want = jax_flash(*(jnp.asarray(x) for x in (q, k2, v2)), bq=16, bk=16,
                     interpret=True)
    np.testing.assert_allclose(out2.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_query_tile_fills_the_kernels_rows():
    assert [fp.query_tile(g) for g in (1, 2, 3, 8, 16, 128)] == [
        128, 64, 42, 16, 8, 1]


def test_kernel_wrapper_refuses_what_it_does_not_take():
    q, k, v = (torch.from_numpy(x) for x in _inputs(1, 8, 1, 2, 16, 0))
    before = fp.flash_prefill.launches
    with pytest.raises(ValueError, match="CUDA"):
        fp.flash_prefill(q, k, v)
    assert fp.flash_prefill.launches == before
