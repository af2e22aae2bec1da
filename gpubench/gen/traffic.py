"""The one generator of the benchmark's data and traffic.

A configuration's ``data`` fixes the deployment's catalog (its size, the
clusters the latent factors gather around, their spread); a traffic mix
(``traffic/<name>.json``) fixes the request size and the mutations set-up
applies.  Everything is drawn from the run's ``--seed`` but the cluster
centres, which belong to the configuration: so every seed serves the same
kind of catalog and the same request sizes, and the seed changes which
rows and users are drawn and in which order.

Traffic keys:

* ``request_size``: users a request.
* ``warmup_requests``: requests sent before the window (same size).
* ``setup_mutations`` (optional): ``rounds`` of ``fresh`` new ids and
  ``rewrite`` ids drawn Zipf(``rewrite_zipf``) over the live ids, upserted
  together with factors drawn like the catalog's, then ``delete`` live ids
  drawn uniformly.
* ``sample``: served queries the comparison judges after the window.

(``loop`` and ``clients`` are the window's: ``bench.set_up`` reads them.)
"""
from __future__ import annotations

import dataclasses

import numpy as np

from gpubench.gen.catalog import clustered_catalog, requests
from gpubench.gen.zipf import zipf_ids

__all__ = ["Traffic", "make", "seeds"]


def seeds(seed: int, n: int) -> list[int]:
    """``n`` independent 64-bit seeds derived from the run's ``seed``."""
    ss = np.random.SeedSequence(int(seed) % (1 << 64))
    return [int(c.generate_state(1, np.uint64)[0]) for c in ss.spawn(n)]


@dataclasses.dataclass
class Traffic:
    centers: np.ndarray       # (C, k) the configuration's cluster centres
    ids: np.ndarray           # (N,) the catalog's ids
    items: np.ndarray         # (N, k) its factors
    pool: np.ndarray          # (U, k) the users
    order: np.ndarray         # (U,) the seeded walk over the users
    request_size: int
    warmup_requests: int
    sample: int
    mutations: list           # ("upsert", ids, factors) / ("delete", ids)

    def request(self, i: int) -> np.ndarray:
        """Users of request ``i`` (``i < 0``: warm-up requests, drawn from
        the far end of the walk), in pool order."""
        b, u = self.request_size, len(self.order)
        at = (i * b + np.arange(b)) % u
        return self.pool[np.sort(self.order[at])]


def make(data: dict, traffic: dict, seed: int) -> Traffic:
    """Draw the catalog, the users, the walk and the mutations."""
    k, sigma = int(data["k"]), float(data["sigma"])
    _, centers = clustered_catalog(int(data["n_clusters"]), k,
                                   int(data["n_clusters"]), sigma,
                                   int(data["center_seed"]))
    s_items, s_users, s_order, s_mut = seeds(seed, 4)
    n = int(data["n_items"])
    items = requests(centers, 1, n, sigma, s_items)[0]
    pool = requests(centers, 1, int(data["n_users"]), sigma, s_users)[0]
    order = np.random.default_rng(s_order).permutation(len(pool))
    ids = np.arange(n, dtype=np.int64)
    mutations = []
    mix = traffic.get("setup_mutations")
    if mix:
        rng = np.random.default_rng(s_mut)
        live, next_id = ids.copy(), n
        for _ in range(int(mix["rounds"])):
            fresh = np.arange(next_id, next_id + int(mix["fresh"]))
            next_id += fresh.size
            rewrite = zipf_ids(rng, live, int(mix["rewrite"]),
                               float(mix["rewrite_zipf"]))
            up_ids = np.concatenate([fresh, rewrite])
            up = requests(centers, 1, up_ids.size, sigma,
                          int(rng.integers(1 << 62)))[0]
            mutations.append(("upsert", up_ids, up))
            live = np.union1d(live, fresh)
            dead = rng.choice(live, int(mix["delete"]), replace=False)
            mutations.append(("delete", dead))
            live = np.setdiff1d(live, dead)
    return Traffic(centers, ids, items, pool, order,
                   int(traffic["request_size"]),
                   int(traffic["warmup_requests"]), int(traffic["sample"]),
                   mutations)
