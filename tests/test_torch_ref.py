"""The port's plain oracles (``repro_torch.kernels.ref``) against
``repro.kernels.ref`` on the same inputs, and the pattern oracle against the
plain fused walk.

Rows, the empty-slot contract and patterns exact; scores within 4 ulp of
each query's dot-product scale (``assert_scores_close``); the attention and
coarse oracles within 1e-5 (f32 softmax / matmul, summed in different
orders by the two packages).
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from conftest import CFG, unit_factors  # noqa: E402
from test_torch_gam_retrieve import assert_scores_close  # noqa: E402

from repro.core.inverted_index import DeviceIndex as JDeviceIndex  # noqa: E402
from repro.core.mapping import sparse_map as j_sparse_map  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
tgr = importlib.import_module("repro_torch.kernels.gam_retrieve")  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

NEG = -1e30


def _mapped(factors):
    tau, vals = j_sparse_map(jnp.asarray(factors), CFG)
    return np.array(tau), np.array(vals) != 0.0


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("n,q,kappa,mo,bucket", [
    (300, 9, 10, 2, None),
    (200, 5, 7, 1, 4),                 # a tiny bucket: spill rows
    (120, 4, 40, 3, None),             # kappa past the candidates
    (150, 6, 10, 0, None),             # min_overlap 0: every item
])
def test_gam_retrieve_ref_matches_reference_and_plain_walk(n, q, kappa, mo,
                                                           bucket):
    items = unit_factors(n, 16, n)
    users = unit_factors(q, 16, n + 1)
    tau, mask = _mapped(items)
    q_tau, q_mask = _mapped(users)
    spill = None
    if bucket is not None:
        rows = np.asarray(JDeviceIndex.build(tau, CFG.p, bucket, mask=mask)
                          .spill)
        spill = np.zeros(n, bool)
        spill[rows] = True
    alive = np.random.default_rng(n).random(n) > 0.1
    w_vals, w_rows = jref.gam_retrieve_ref(users, items, q_tau, q_mask, tau,
                                           mask, kappa, min_overlap=mo,
                                           spill=spill, alive=alive)
    vals, rows = tref.gam_retrieve_ref(users, items, q_tau, q_mask, tau, mask,
                                       kappa, min_overlap=mo, spill=spill,
                                       alive=alive)
    w_vals, w_rows = np.asarray(w_vals), np.asarray(w_rows)
    assert rows.dtype == torch.int32
    np.testing.assert_array_equal(rows.numpy(), w_rows)
    empty = w_rows < 0
    assert (vals.numpy()[empty] == np.float32(NEG)).all()
    assert_scores_close(np.where(empty, 0, vals.numpy()),
                        np.where(empty, 0, w_vals), users, items)
    # the plain fused walk (bitsets, block unions) gives the same rows
    meta = tgr.build_retrieval_meta(
        tau, mask, CFG.p, bn=64, device="cpu",
        spill_rows=None if spill is None else np.nonzero(spill)[0])
    walk = tgr.gam_retrieve_plain(_t(users), _t(items), _t(q_tau), _t(q_mask),
                                  meta, kappa, min_overlap=mo,
                                  alive=_t(alive))
    np.testing.assert_array_equal(walk.rows.numpy(), rows.numpy())


def test_small_oracles_match_reference():
    rng = np.random.default_rng(0)
    u = rng.normal(size=(5, 16)).astype(np.float32)
    v = rng.normal(size=(40, 16)).astype(np.float32)
    mask = rng.random((5, 40)) > 0.5
    np.testing.assert_allclose(tref.gam_score_ref(u, v, mask).numpy(),
                               np.asarray(jref.gam_score_ref(u, v, mask)),
                               rtol=1e-6, atol=1e-6)
    z = rng.normal(size=(30, 12)).astype(np.float32)
    pat, a = tref.tess_project_ref(torch.from_numpy(z))
    w_pat, w_a = jref.tess_project_ref(jnp.asarray(z))
    np.testing.assert_array_equal(pat.numpy(), np.asarray(w_pat))
    np.testing.assert_allclose(a.numpy(), np.asarray(w_a), rtol=0, atol=1e-6)
    h = rng.normal(size=(3, 16)).astype(np.float32)
    pats = rng.integers(-1, 2, size=(16, 50)).astype(np.int8)
    inv = rng.random(50).astype(np.float32)
    np.testing.assert_allclose(
        tref.gam_coarse_ref(_t(h), _t(pats), _t(inv)).numpy(),
        np.asarray(jref.gam_coarse_ref(jnp.asarray(h), jnp.asarray(pats),
                                       jnp.asarray(inv))),
        rtol=1e-5, atol=1e-5)


def test_attention_oracles_match_reference():
    dtype = np.float32
    rng = np.random.default_rng(1)
    b, s, hkv, g, hd = 2, 24, 2, 3, 16
    q = rng.normal(size=(b, hkv, g, hd)).astype(dtype)
    k = rng.normal(size=(b, s, hkv, hd)).astype(dtype)
    v = rng.normal(size=(b, s, hkv, hd)).astype(dtype)
    got = tref.decode_attention_ref(_t(q), _t(k), _t(v), 11)
    want = jref.decode_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), 11)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    qp = rng.normal(size=(b, s, hkv, g, hd)).astype(dtype)
    got = tref.flash_prefill_ref(_t(qp), _t(k), _t(v))
    want = jref.flash_prefill_ref(jnp.asarray(qp), jnp.asarray(k),
                                  jnp.asarray(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
