"""The port's map phi against the JAX reference: Algorithm 2, the permutation
schemes, ``sparse_map`` and the plain ``tess_project``.

Patterns, tau and values must match exactly.  The one allowed exception is a
row that is a certified near-tie: recomputed in float64, its top two scaled
running sums lie within 4 f32 ulp of each other, so the argmax t* depends on
rounding (the reference's own two forms of Algorithm 2 disagree on such
rows).  Each test counts the rows it excused and fails on any other
difference.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from conftest import CFG  # noqa: E402

from repro.configs import gam_mf  # noqa: E402
from repro.core import mapping as jmap  # noqa: E402
from repro.core import permutation as jperm  # noqa: E402
from repro.core import tessellation as jtess  # noqa: E402
from repro.kernels.tess_project import tess_project as pallas_tess_project  # noqa: E402
from repro_torch.core import mapping as tmap  # noqa: E402
from repro_torch.core import permutation as tperm  # noqa: E402
from repro_torch.core import tessellation as ttess  # noqa: E402
from repro_torch.kernels.tess_project import tess_project_plain  # noqa: E402

NEAR_TIE_ULP = 4


def near_tie_rows(z: np.ndarray) -> np.ndarray:
    """Rows whose top two float64 scaled running sums are within 4 f32 ulp."""
    az = -np.sort(-np.abs(np.asarray(z, np.float64)), axis=-1)
    zs = np.cumsum(az, axis=-1) / np.sqrt(np.arange(1, az.shape[-1] + 1))
    top2 = -np.sort(-zs, axis=-1)[:, :2]
    if top2.shape[1] < 2:
        return np.zeros(len(z), bool)
    gap = top2[:, 0] - top2[:, 1]
    return gap <= NEAR_TIE_ULP * np.spacing(top2[:, 0].astype(np.float32))


def assert_rows_equal_or_near_tie(got, want, z) -> int:
    """Exact row equality except certified near-ties; returns rows excused."""
    got, want = np.asarray(got), np.asarray(want)
    diff = (got != want).reshape(len(got), -1).any(axis=1)
    excused = near_tie_rows(z)
    bad = np.nonzero(diff & ~excused)[0]
    assert bad.size == 0, f"rows {bad[:10]} differ and are not near-ties"
    return int((diff & excused).sum())


def _rows(n, k, seed, threshold=0.0):
    z = np.random.default_rng(seed).normal(size=(n, k)).astype(np.float32)
    z /= np.linalg.norm(z, axis=1, keepdims=True)
    if threshold:
        z = np.where(np.abs(z) >= threshold, z, 0.0).astype(np.float32)
    return z


@pytest.mark.parametrize("k", [8, 10, 12, 16, 64])
@pytest.mark.parametrize("threshold", [0.0, 0.2])
def test_ternary_pattern_and_tess_vector_match_reference(k, threshold):
    z = _rows(4096, k, 100 + k, threshold)
    want_pat = np.asarray(jtess.ternary_pattern(jnp.asarray(z)))
    got_pat = ttess.ternary_pattern(torch.from_numpy(z)).numpy()
    assert got_pat.dtype == np.int8
    excused = assert_rows_equal_or_near_tie(got_pat, want_pat, z)
    same = (got_pat == want_pat).all(axis=1)
    want_a = np.asarray(jtess.tess_vector(jnp.asarray(z)))
    got_a = ttess.tess_vector(torch.from_numpy(z)).numpy()
    np.testing.assert_array_equal(got_a[same], want_a[same])
    assert excused <= 4, f"{excused} near-tie rows excused"


def test_near_tie_rows_are_certified_not_assumed():
    """A hand-made exact tie is certified; a clear winner is not."""
    # z_s^0 = 1 and z_s^1 = (1 + (sqrt(2) - 1)) / sqrt(2) = 1 in the reals
    tie = np.array([[1.0, np.sqrt(2) - 1, 0.0, 0.0]], np.float32)
    clear = np.array([[1.0, 0.1, 0.0, 0.0]], np.float32)
    assert near_tie_rows(tie)[0]
    assert not near_tie_rows(clear)[0]


@pytest.mark.parametrize("k,d", [(8, 2), (16, 4), (10, 1)])
def test_dary_pattern_matches_reference(k, d):
    z = _rows(2048, k, 7 * k + d)
    np.testing.assert_array_equal(
        tperm.one_hot_dary_tau(ttess.dary_pattern(torch.from_numpy(z), d),
                               d).numpy(),
        np.asarray(jperm.one_hot_dary_tau(jtess.dary_pattern(
            jnp.asarray(z), d), d)))
    np.testing.assert_allclose(
        ttess.tess_vector_d(torch.from_numpy(z), d).numpy(),
        np.asarray(jtess.tess_vector_d(jnp.asarray(z), d)), rtol=0,
        atol=4 * np.finfo(np.float32).eps)


@pytest.mark.parametrize("k", [8, 10, 16, 64])
def test_permutations_match_reference(k):
    pat = np.random.default_rng(k).integers(-1, 2, size=(512, k)).astype(np.int8)
    pat[0] = 0                       # no non-zero at all
    pat[1, 1:] = 0                   # trailing zero-run
    for jfn, tfn in ((jperm.parse_tree_tau, tperm.parse_tree_tau),
                     (jperm.one_hot_tau, tperm.one_hot_tau)):
        want = np.asarray(jfn(jnp.asarray(pat)))
        got = tfn(torch.from_numpy(pat)).numpy()
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)
    assert tperm.parse_tree_dim(k) == jperm.parse_tree_dim(k)
    tau_a = np.array(jperm.one_hot_tau(jnp.asarray(pat)))
    tau_b = np.array(jperm.one_hot_tau(jnp.asarray(pat[::-1].copy())))
    np.testing.assert_array_equal(
        tperm.kendall_tau_distance(torch.from_numpy(tau_a),
                                   torch.from_numpy(tau_b)).numpy(),
        np.asarray(jperm.kendall_tau_distance(jnp.asarray(tau_a),
                                              jnp.asarray(tau_b))))


def _cfg_pair(k, scheme="parse_tree", threshold=0.0, d=1):
    return (jmap.GamConfig(k=k, scheme=scheme, threshold=threshold, d=d),
            tmap.GamConfig(k=k, scheme=scheme, threshold=threshold, d=d))


@pytest.mark.parametrize("jcfg", [
    gam_mf.GAM, CFG,
    jmap.GamConfig(k=8), jmap.GamConfig(k=12, scheme="one_hot"),
    jmap.GamConfig(k=64, threshold=0.1),
    jmap.GamConfig(k=16, scheme="one_hot_dary", d=3),
], ids=lambda c: f"{c.scheme}-k{c.k}-t{c.threshold}-d{c.d}")
def test_sparse_map_matches_reference(jcfg):
    jc, tc = _cfg_pair(jcfg.k, jcfg.scheme, jcfg.threshold, jcfg.d)
    assert tc.p == jc.p
    z = _rows(4096, jcfg.k, jcfg.k + 1000)
    want_tau, want_vals = jmap.sparse_map(jnp.asarray(z), jc)
    got_tau, got_vals = tmap.sparse_map(torch.from_numpy(z), tc)
    np.testing.assert_array_equal(got_vals.numpy(), np.asarray(want_vals))
    zt = np.array(want_vals)
    excused = assert_rows_equal_or_near_tie(got_tau.numpy(),
                                            np.asarray(want_tau), zt)
    assert excused <= 4, f"{excused} near-tie rows excused"
    # densify / pattern_overlap agree on the same maps
    tau = np.array(want_tau)
    np.testing.assert_array_equal(
        tmap.densify(torch.from_numpy(tau[:64]),
                     torch.from_numpy(zt[:64]), jc.p).numpy(),
        np.asarray(jmap.densify(jnp.asarray(tau[:64]), jnp.asarray(zt[:64]),
                                jc.p)))
    np.testing.assert_array_equal(
        tmap.pattern_overlap(torch.from_numpy(tau[:64]),
                             torch.from_numpy(tau[64:128])).numpy(),
        np.asarray(jmap.pattern_overlap(jnp.asarray(tau[:64]),
                                        jnp.asarray(tau[64:128]))))


def test_sparse_map_rejects_wrong_width():
    with pytest.raises(ValueError):
        tmap.sparse_map(torch.zeros(3, 5), tmap.GamConfig(k=4))


@pytest.mark.parametrize("b,k", [(4, 8), (100, 16), (257, 10), (32, 64),
                                 (1, 12)])
def test_plain_tess_project_matches_pallas(b, k):
    z = np.random.default_rng(b + k).normal(size=(b, k)).astype(np.float32)
    want_pat, want_a = pallas_tess_project(jnp.asarray(z), bb=64,
                                           interpret=True)
    got_pat, got_a = tess_project_plain(torch.from_numpy(z))
    got_pat, got_a = got_pat.numpy(), got_a.numpy()
    excused = assert_rows_equal_or_near_tie(got_pat, np.asarray(want_pat), z)
    same = (got_pat == np.asarray(want_pat)).all(axis=1)
    # the Pallas kernel multiplies by rsqrt(t+1), the port divides by sqrt
    np.testing.assert_array_max_ulp(got_a[same], np.asarray(want_a)[same],
                                    maxulp=NEAR_TIE_ULP)
    assert excused <= 1, f"{excused} near-tie rows excused"
    # the plain version is exactly the port's Algorithm 2
    np.testing.assert_array_equal(
        got_pat, ttess.ternary_pattern(torch.from_numpy(z)).numpy())
    np.testing.assert_array_equal(
        got_a, ttess.tess_vector(torch.from_numpy(z)).numpy())


def test_plain_tess_project_scale_invariant():
    z = torch.from_numpy(np.random.default_rng(3).normal(size=(16, 12))
                         .astype(np.float32))
    np.testing.assert_array_equal(tess_project_plain(z)[0].numpy(),
                                  tess_project_plain(z * 37.0)[0].numpy())
