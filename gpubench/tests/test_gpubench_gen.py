"""The frozen generators draw what the originals draw for a seed."""
import importlib.util

import numpy as np
import pytest

from gpubench.tests._common import ROOT
from gpubench.gen import catalog, traffic, zipf


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 11])
def test_catalog_generators_match_chip_smoke(seed):
    smoke = _chip_smoke()
    a, ca = catalog.clustered_catalog(1000, 10, 64, 0.05, seed)
    b, cb = smoke.clustered_catalog(1000, 10, 64, 0.05, seed)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ca, cb)
    for x, y in zip(catalog.requests(ca, 3, 256, 0.05, seed),
                    smoke.requests(cb, 3, 256, 0.05, seed)):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("seed", [0, 3, 2**31 + 5])
def test_zipf_draws_match_loadgen(seed):
    from repro_torch.service.loadgen import (LoadGenerator, LoadProfile,
                                             zipf_weights)
    np.testing.assert_array_equal(zipf.zipf_weights(500, 1.1),
                                  zipf_weights(500, 1.1))
    ids = np.arange(10, 510, dtype=np.int64)
    gen = LoadGenerator(LoadProfile(n_queries=16, zipf_items=1.1, seed=seed),
                        dim=10, item_ids=ids)
    want, _ = gen.sample_upserts(300)
    rng = np.random.default_rng(seed)
    rng.standard_normal((16, 10))           # the generator's query pool
    np.testing.assert_array_equal(zipf.zipf_ids(rng, ids, 300, 1.1), want)


def test_traffic_is_a_function_of_the_seed():
    data = {"n_items": 500, "n_users": 300, "k": 10, "n_clusters": 8,
            "sigma": 0.05, "center_seed": 1}
    mix = {"request_size": 32, "warmup_requests": 1, "sample": 64,
           "setup_mutations": {"rounds": 2, "fresh": 8, "rewrite": 8,
                               "rewrite_zipf": 1.1, "delete": 4}}
    a, b = traffic.make(data, mix, 2**31 + 1), traffic.make(data, mix,
                                                            2**31 + 1)
    c = traffic.make(data, mix, 2**31 + 2)
    np.testing.assert_array_equal(a.items, b.items)
    np.testing.assert_array_equal(a.request(3), b.request(3))
    np.testing.assert_array_equal(a.centers, c.centers)  # the configuration's
    assert not np.array_equal(a.items, c.items)
    for x, y in zip(a.mutations, b.mutations):
        for u, v in zip(x[1:], y[1:]):
            np.testing.assert_array_equal(u, v)
    assert a.request(0).shape == (32, 10)
    assert len(a.mutations) == 4
