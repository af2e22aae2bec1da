"""The port's ``gam_coarse`` against ``repro``'s, on the CPU.

The plain version (what ``ops.gam_coarse`` runs on a CPU tensor) is held
against the JAX Pallas kernel in interpret mode and ``kernels.ref
.gam_coarse_ref`` at the shapes of ``tests/test_kernels.py``, with the
reference's tolerance (rtol = atol = 1e-5: the sums over d run in other
orders), plus a V that is not a multiple of 512 and int8 values outside
{-1, 0, 1}.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.kernels import ref  # noqa: E402
from repro.kernels.gam_coarse import gam_coarse as jax_coarse  # noqa: E402
from repro_torch.kernels import gam_coarse as gc  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402


def _inputs(b, d, v, lo=-1, hi=2):
    r = np.random.default_rng(b * d + v)
    h = r.normal(size=(b, d)).astype(np.float32)
    pat = r.integers(lo, hi, size=(d, v)).astype(np.int8)
    nnz = np.abs(pat.astype(np.float32)).sum(0)
    inv = (1.0 / np.sqrt(np.maximum(nnz, 1.0))).astype(np.float32)
    return h, pat, inv


@pytest.mark.parametrize("b,d,v,lo,hi", [
    (1, 64, 500, -1, 2), (4, 128, 4096, -1, 2), (8, 32, 100, -1, 2),
    (2, 256, 2049, -1, 2), (3, 96, 1000, -1, 2), (5, 40, 777, -128, 128)])
def test_plain_gam_coarse_matches_reference(b, d, v, lo, hi):
    h, pat, inv = _inputs(b, d, v, lo, hi)
    got = ops.gam_coarse(*(torch.from_numpy(x) for x in (h, pat, inv)))
    assert got.dtype == torch.float32 and tuple(got.shape) == (b, v)
    jh, jp, ji = jnp.asarray(h), jnp.asarray(pat), jnp.asarray(inv)
    want = jax_coarse(jh, jp, ji, bv=512, interpret=True)
    oracle = ref.gam_coarse_ref(jh, jp, ji)
    # scale the absolute tolerance with the terms' magnitude for wide int8
    atol = 1e-5 * max(1.0, float(np.abs(pat).max()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=atol)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), rtol=1e-5,
                               atol=atol)
    # the reference's answer lies within the stated rounding bound too
    tol = gc.coarse_tolerance(*(torch.from_numpy(x) for x in (h, pat, inv)))
    assert (np.abs(got.numpy() - np.asarray(want)) <= tol.numpy()).all()


def test_kernel_wrapper_refuses_what_it_does_not_take():
    h, pat, inv = (torch.from_numpy(x) for x in _inputs(2, 8, 10))
    before = gc.gam_coarse.launches
    with pytest.raises(ValueError, match="CUDA"):
        gc.gam_coarse(h, pat, inv)
    assert gc.gam_coarse.launches == before
