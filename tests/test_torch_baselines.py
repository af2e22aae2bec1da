"""The port's §5.1 baselines against ``repro.core.baselines``, on the CPU.

* Planes and projections are bitwise the reference's for the same seed.
* On the reference's own structure (``baseline_from_reference``) the
  query's candidates equal the reference's, except for queries whose
  projection lies within the rounding bound of a hyperplane, a CRO top-l
  boundary or a PCA median: the two packages sum a dot product in
  different orders, each within ``k * 2^-24 * sum |u_i w_i|`` of the exact
  value, so they may land on two sides of a boundary only within twice
  that (``_bound``).  Such queries are counted and held to a few.
* Built from the seed, item codes equal the reference's but for items near
  a boundary (counted); the PCA tree's recall is within ``RECALL_TOL`` of
  the reference's.
* Pruned answers are the exact top kappa of the candidates; ``exact=True``
  is ``brute``.  Scores within 4 ulp of the dot-product scale; ids compared
  as sets per query (the reference breaks score ties in no fixed order).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from test_torch_gam_retrieve import assert_scores_close  # noqa: E402

from repro.core import baselines as jb  # noqa: E402
from repro.core.mapping import GamConfig as JConfig  # noqa: E402
from repro.core.retrieval import recovery_accuracy  # noqa: E402
from repro.retriever import RetrieverSpec as JSpec  # noqa: E402
from repro.retriever import open_retriever as j_open  # noqa: E402
from repro_torch.core import baselines as tb  # noqa: E402
from repro_torch.core.mapping import GamConfig  # noqa: E402
from repro_torch.retriever import RetrieverSpec, open_retriever  # noqa: E402
from repro_torch.retriever.baselines import (  # noqa: E402
    baseline_from_reference)

CPU = "cpu"
EPS = 2.0 ** -24
RECALL_TOL = 0.05
MAX_BOUNDARY_QUERIES = 2      # of Q queries, on the reference's structure


def _factors(n, k, seed):
    z = np.random.default_rng(seed).normal(size=(n, k)).astype(np.float32)
    return z / np.linalg.norm(z, axis=1, keepdims=True)


K, N, Q, KAPPA = 12, 400, 25, 10
ITEMS = _factors(N, K, 0)
USERS = _factors(Q, K, 1)
BRUTE = open_retriever(RetrieverSpec(cfg=GamConfig(k=K), backend="brute"),
                       items=ITEMS, device=CPU).query(USERS, KAPPA)

KINDS = [
    ("SrpLsh", dict(n_bits=4, n_tables=8)),
    ("SuperBitLsh", dict(n_bits=4, n_tables=8)),
    ("SuperBitLsh", dict(n_bits=16, n_tables=3, seed=5)),   # n_bits > k
    ("CroHash", dict(n_proj=8, top_l=2, n_tables=8)),
    ("CroHash", dict(n_proj=24, top_l=3, n_tables=2, seed=3)),
    ("PcaTree", dict(depth=3)),
    ("PcaTree", dict(depth=6)),
]
IDS = [f"{c}-{'-'.join(f'{k}{v}' for k, v in kw.items())}" for c, kw in KINDS]


def _bound(x, w):
    """(B, k) x (k, m) -> (B, m): how far two f32 sums of x_i w_i may lie
    apart."""
    x, w = np.asarray(x, np.float64), np.asarray(w, np.float64)
    return 2 * x.shape[1] * EPS * (np.abs(x)[:, :, None]
                                   * np.abs(w)[None]).sum(1)


def _near_boundary(ref, x):
    """(B,) bool: rows of ``x`` that may hash or descend differently in the
    two packages on ``ref``'s structure."""
    x = np.asarray(x, np.float32)
    if isinstance(ref, jb.PcaTree):
        out = np.zeros(len(x), bool)
        for i, u in enumerate(x):
            path = ()
            while path in ref._splits:
                v, med = ref._splits[path]
                p = float(np.float64(u) @ np.float64(v))
                out[i] |= abs(p - med) <= _bound(u[None], v[:, None])[0, 0]
                path = path + (0 if float(u @ v) <= med else 1,)
        return out
    w_all = ref._proj if isinstance(ref, jb.CroHash) else ref._planes
    out = np.zeros(len(x), bool)
    for w in w_all:
        z = x.astype(np.float64) @ w.astype(np.float64)
        b = _bound(x, w)
        if isinstance(ref, jb.CroHash):
            zs = -np.sort(-z, axis=1)
            gap = zs[:, ref.top_l - 1] - zs[:, ref.top_l]
            out |= gap <= 2 * b.max(axis=1)
        else:
            out |= (np.abs(z) <= b).any(axis=1)
    return out


def _ref_candidates(ref, users):
    users = np.asarray(users, np.float32)
    if isinstance(ref, jb.PcaTree):
        return [np.sort(ref._leaf(u)) for u in users]
    out = []
    for u in users:
        hit = set()
        for t in range(ref.n_tables):
            hit.update(ref.tables[t].get(ref._hash(u[None], t)[0], ()))
        out.append(np.array(sorted(hit), np.int64))
    return out


def _port_candidates(impl, users):
    qrow, rows = impl.candidates(torch.from_numpy(np.asarray(users)))
    qrow, rows = qrow.numpy(), rows.numpy()
    return [rows[qrow == qi] for qi in range(len(users))]


def _build(kind, kwargs, items=ITEMS):
    ref = getattr(jb, kind)(items, **kwargs)
    return ref, getattr(tb, kind)(items, **kwargs, device=CPU)


# ------------------------------------------------------- planes, structure


@pytest.mark.parametrize("kind,kwargs", KINDS, ids=IDS)
def test_planes_and_projections_bitwise_equal_reference(kind, kwargs):
    ref, got = _build(kind, kwargs)
    if kind == "CroHash":
        assert got.proj.dtype == torch.float32
        np.testing.assert_array_equal(got.proj.numpy(), ref._proj)
    elif kind != "PcaTree":
        assert got.planes.dtype == torch.float32
        np.testing.assert_array_equal(got.planes.numpy(), ref._planes)
        if kind == "SuperBitLsh":
            for w in got.planes.numpy():
                np.testing.assert_allclose(w.T @ w, np.eye(w.shape[1]),
                                           atol=1e-5)
    else:
        # same split directions at the root (up to sign) and medians
        v, med = ref._splits[()]
        mine = got.split_v[0].numpy()
        assert abs(abs(float(v @ mine)) - 1) < 1e-4
        assert abs(float(got.split_med[0]) - med) < 1e-4


@pytest.mark.parametrize("kind,kwargs", KINDS, ids=IDS)
def test_candidates_on_reference_structure_equal_but_boundary(kind, kwargs):
    ref = getattr(jb, kind)(ITEMS, **kwargs)
    port = baseline_from_reference(ref, device=CPU)
    want = _ref_candidates(ref, USERS)
    got = _port_candidates(port, USERS)
    near = _near_boundary(ref, USERS)
    differ = np.array([not np.array_equal(a, b) for a, b in zip(got, want)])
    assert not (differ & ~near).any(), np.nonzero(differ & ~near)[0]
    assert differ.sum() <= MAX_BOUNDARY_QUERIES
    # queries hashed alike answer alike: exact top kappa of the candidates
    res, ref_res = port.query(USERS, KAPPA), ref.query(USERS, KAPPA)
    same = ~differ
    np.testing.assert_array_equal(res.n_scored[same], ref_res.n_scored[same])
    np.testing.assert_array_equal(res.discarded_frac[same],
                                  ref_res.discarded_frac[same])
    for qi in np.nonzero(same)[0]:
        assert set(res.ids[qi]) == set(ref_res.ids[qi])
    real = ref_res.ids[same] >= 0
    assert_scores_close(np.where(real, res.scores[same], 0),
                        np.where(real, ref_res.scores[same], 0),
                        USERS[same], ITEMS)


@pytest.mark.parametrize("kind,kwargs", [k for k in KINDS
                                         if k[0] != "PcaTree"],
                         ids=[i for i in IDS if not i.startswith("Pca")])
def test_item_codes_built_from_seed_equal_reference_but_boundary(kind,
                                                                 kwargs):
    ref, got = _build(kind, kwargs)
    copied = baseline_from_reference(ref, device=CPU)
    near = _near_boundary(ref, ITEMS)
    for t in range(ref.n_tables):
        mine = torch.empty(N, dtype=torch.int64)
        mine[got.table_items[t]] = got.table_codes[t]
        theirs = torch.empty(N, dtype=torch.int64)
        theirs[copied.table_items[t]] = copied.table_codes[t]
        differ = (mine != theirs).numpy()
        assert not (differ & ~near).any()
    assert near.sum() <= 3


@pytest.mark.parametrize("depth", [3, 4, 6])
def test_pca_tree_built_from_seed_recall_within_tolerance(depth):
    ref, got = _build("PcaTree", dict(depth=depth))
    a = recovery_accuracy(ref.query(USERS, KAPPA).ids, BRUTE.ids).mean()
    b = recovery_accuracy(got.query(USERS, KAPPA).ids, BRUTE.ids).mean()
    assert abs(a - b) <= RECALL_TOL
    # leaves partition the items, as the reference's do
    assert sorted(got.leaf_items.tolist()) == list(range(N))
    assert got.leaf_len.sum() == N


# ---------------------------------------------- the reference suite's cases


@pytest.mark.parametrize("kind,kwargs", KINDS[:2] + KINDS[3:4] + KINDS[5:6],
                         ids=IDS[:2] + IDS[3:4] + IDS[5:6])
def test_baseline_interface_and_scores_exact(kind, kwargs):
    r = getattr(tb, kind)(ITEMS, **kwargs, device=CPU)
    res = r.query(USERS, KAPPA)
    assert res.ids.shape == (Q, KAPPA)
    assert res.discarded_frac.shape == (Q,)
    assert (res.discarded_frac >= 0).all() and (res.discarded_frac <= 1).all()
    for qi in range(Q):
        for slot in range(KAPPA):
            iid = res.ids[qi, slot]
            if iid >= 0:
                np.testing.assert_allclose(res.scores[qi, slot],
                                           USERS[qi] @ ITEMS[iid], rtol=1e-4)
    acc = recovery_accuracy(res.ids, BRUTE.ids).mean()
    frac_kept = 1 - res.discarded_frac.mean()
    assert acc >= min(frac_kept * 1.2, 0.2) or acc > 0.2


def test_pruned_answers_are_the_exact_top_kappa_of_the_candidates():
    """(score desc, row asc) over each query's own candidates, ties
    included."""
    items = np.concatenate([ITEMS, ITEMS[:50]])            # exact ties
    r = tb.SrpLsh(items, n_bits=3, n_tables=2, device=CPU)
    res = r.query(USERS, KAPPA)
    for qi, cand in enumerate(_port_candidates(r, USERS)):
        scores = items[cand] @ USERS[qi]
        order = np.lexsort((cand, -scores))[:KAPPA]
        kk = min(KAPPA, cand.size)
        np.testing.assert_array_equal(res.ids[qi, :kk], cand[order])
        assert res.n_scored[qi] == cand.size


def test_more_tables_improves_recall():
    r2 = tb.SrpLsh(ITEMS, n_bits=6, n_tables=2, seed=0, device=CPU)
    r16 = tb.SrpLsh(ITEMS, n_bits=6, n_tables=16, seed=0, device=CPU)
    a2 = recovery_accuracy(r2.query(USERS, KAPPA).ids, BRUTE.ids).mean()
    a16 = recovery_accuracy(r16.query(USERS, KAPPA).ids, BRUTE.ids).mean()
    assert a16 >= a2


def test_pca_tree_leaves_partition_items():
    tree = tb.PcaTree(ITEMS, depth=4, device=CPU)
    assert sorted(tree.leaf_items.tolist()) == list(range(N))
    leaves = tree.child[:, 0] < 0
    assert int(tree.leaf_len[leaves].sum()) == N
    assert (tree.leaf_len[~leaves] == 0).all()


def test_codes_past_int64_are_refused():
    with pytest.raises(ValueError, match="63"):
        tb.SrpLsh(ITEMS, n_bits=64, n_tables=1, device=CPU)
    with pytest.raises(ValueError, match="int64"):
        tb.CroHash(ITEMS, n_proj=1000, top_l=7, n_tables=1, device=CPU)


# ---------------------------------------------------- the backends, end to end


@pytest.mark.parametrize("backend", ["srp-lsh", "superbit-lsh", "cro",
                                     "pca-tree"])
def test_baseline_backends_match_reference(backend):
    items = _factors(600, 16, 30)
    users = _factors(20, 16, 31)
    ids = np.arange(600, dtype=np.int64) * 5 + 3
    spec = RetrieverSpec(cfg=GamConfig(k=16), backend=backend, seed=4)
    jspec = JSpec(cfg=JConfig(k=16), backend=backend, seed=4)
    got = open_retriever(spec, items=items, ids=ids, device=CPU)
    want = j_open(jspec, items=items, ids=ids)
    brute = open_retriever(RetrieverSpec(cfg=GamConfig(k=16), backend="brute"),
                           items=items, ids=ids, device=CPU)
    ex = got.query(users, KAPPA, exact=True)
    np.testing.assert_array_equal(ex.ids, brute.query(users, KAPPA).ids)
    np.testing.assert_array_equal(ex.n_scored, np.full(20, 600))
    res, ref = got.query(users, KAPPA), want.query(users, KAPPA)
    truth = brute.query(users, KAPPA).ids
    a = recovery_accuracy(res.ids, truth).mean()
    b = recovery_accuracy(ref.ids, truth).mean()
    assert abs(a - b) <= RECALL_TOL
    assert set(res.ids[res.ids >= 0]) <= set(ids)
    if backend != "pca-tree":           # hashes: the same seed, same tables
        assert (res.n_scored == ref.n_scored).mean() >= 0.9
