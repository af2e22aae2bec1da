"""The frozen reference's phi and top-kappa agree with the port's CPU path
at small sizes, and the comparison tells answers apart."""
import numpy as np
import pytest
import torch

from gpubench.tests._common import ROOT  # noqa: F401  (puts the checkout on the path)
from gpubench.gen.catalog import requests
from gpubench.reference.compare import judge
from gpubench.reference.phi import parse_tree_dim, phi
from gpubench.reference.retrieval import (Answer, Catalog, answer,
                                          live_catalog)
from repro_torch.core.mapping import GamConfig, sparse_map
from repro_torch.retriever import RetrieverSpec, open_retriever


def _rows(n, k, seed, centers=16):
    rng = np.random.default_rng(seed)
    c = rng.normal(size=(centers, k)).astype(np.float32)
    c /= np.linalg.norm(c, axis=1, keepdims=True)
    return requests(c, 1, n, 0.05, seed)[0]


@pytest.mark.parametrize("k,threshold", [(10, 0.2), (16, 0.2), (10, 0.0)])
def test_phi_equals_the_port(k, threshold):
    z = _rows(4000, k, k)
    tau, mask = phi(z, threshold)
    t, v = sparse_map(torch.from_numpy(z),
                      GamConfig(k=k, scheme="parse_tree",
                                threshold=threshold))
    np.testing.assert_array_equal(tau, t.numpy())
    np.testing.assert_array_equal(mask, (v != 0).numpy())
    assert parse_tree_dim(k) == GamConfig(k=k).p


@pytest.mark.parametrize("backend", ["gam-device", "sharded"])
def test_top_kappa_equals_the_port(backend):
    items, users = _rows(3000, 10, 1), _rows(200, 10, 2)
    spec = RetrieverSpec(cfg=GamConfig(k=10, threshold=0.2),
                         backend=backend, min_overlap=2, kappa=10,
                         bucket=3000, n_shards=3 if backend == "sharded"
                         else 1)
    got = open_retriever(spec, items=items, device="cpu").query(users)
    cat = Catalog.of(np.arange(3000), items, 0.2)
    ref = answer(cat, users, threshold=0.2, min_overlap=2, kappa=10,
                 device="cpu")
    np.testing.assert_array_equal(got.n_scored, ref.n_scored)
    np.testing.assert_array_equal(got.ids, ref.ids)
    real = ref.ids >= 0
    np.testing.assert_allclose(got.scores[real], ref.scores[real],
                               rtol=0, atol=1e-6)
    numbers = judge(Answer(got.ids, got.scores, got.n_scored), ref, cat,
                    users, threshold=0.2, min_overlap=2)
    assert numbers["n_scored_gap"] == 0.0
    assert numbers["rank_gap"] < 1e-6 and numbers["score_err"] < 1e-6


def test_live_catalog_replays_in_order():
    ids = np.arange(5)
    fac = np.eye(5, 10, dtype=np.float32)
    up = np.full((3, 10), 2.0, np.float32)
    up[2] = 3.0
    got_ids, got = live_catalog(ids, fac, [
        ("upsert", np.array([1, 7, 1]), up), ("delete", np.array([0, 7]))])
    np.testing.assert_array_equal(got_ids, [1, 2, 3, 4])
    np.testing.assert_array_equal(got[0], np.full(10, 3.0))   # last write
    np.testing.assert_array_equal(got[1:], fac[2:])


def test_judge_reads_each_fault():
    items, users = _rows(2000, 10, 3), _rows(64, 10, 4)
    cat = Catalog.of(np.arange(2000), items, 0.2)
    ref = answer(cat, users, threshold=0.2, min_overlap=2, kappa=10,
                 device="cpu")
    served = Answer(ref.ids.copy(), ref.scores.astype(np.float32),
                    ref.n_scored.copy())
    kw = dict(threshold=0.2, min_overlap=2)
    assert max(judge(served, ref, cat, users, **kw).values()) < 1e-6
    wrong = Answer(served.ids.copy(), served.scores, served.n_scored)
    wrong.ids[5, 0] = (wrong.ids[5, 0] + 1) % 2000
    assert judge(wrong, ref, cat, users, **kw)["rank_gap"] > 1e-3
    miss = Answer(served.ids.copy(), served.scores, served.n_scored)
    miss.ids[7, 3] = -1
    assert judge(miss, ref, cat, users, **kw)["rank_gap"] >= 1.0
    count = Answer(served.ids, served.scores, served.n_scored + 5)
    assert judge(count, ref, cat, users, **kw)["n_scored_gap"] > 1e-3
    off = Answer(served.ids, served.scores + 1e-3, served.n_scored)
    assert judge(off, ref, cat, users, **kw)["score_err"] > 5e-4
