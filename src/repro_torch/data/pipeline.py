"""Data pipeline of the port: deterministic synthetic streams for LM training
and the paper's ratings experiments (a copy of ``repro.data.pipeline``).

* ``TokenPipeline`` — an infinite, seeded, shardable LM token stream with a
  Zipfian unigram distribution and short-range Markov structure, so models
  trained a few hundred steps show a real loss decrease.
* ``synthetic_ratings`` — the paper's §6.1 protocol: U, V ~ N(0, 1),
  R = U V^T.
* ``movielens_like_ratings`` — §6.2 surrogate: a ratings
  matrix with MovieLens100k's shape (943 x 1682), ~6.3% density, Zipfian item
  popularity and clustered user tastes.

All three are numpy and give the reference's arrays bit for bit.
``shard_batch`` places a host batch on a device mesh.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["TokenPipeline", "synthetic_ratings", "movielens_like_ratings",
           "shard_batch"]


@dataclasses.dataclass
class TokenPipeline:
    """Seeded synthetic LM token stream.

    Tokens follow a mixture: with prob 0.75 the next token is a deterministic
    function of the previous one (learnable structure), else Zipf-distributed
    noise.  Batches are (batch, seq_len+1); split into inputs/labels by the
    caller.
    """

    vocab: int
    seq_len: int
    batch: int
    seed: int = 0
    structure_seed: int = 0   # the "language" (successor table); held-out
                              # streams share it while varying ``seed``

    def __post_init__(self):
        rng = np.random.default_rng(self.structure_seed)
        # fixed random successor table = the learnable structure
        self._succ = rng.integers(0, self.vocab, size=self.vocab, dtype=np.int32)
        ranks = np.arange(1, self.vocab + 1, dtype=np.float64)
        probs = 1.0 / ranks**1.1
        self._zipf = (probs / probs.sum()).astype(np.float64)

    def batch_at(self, step: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed, step))
        out = np.empty((self.batch, self.seq_len + 1), np.int32)
        cur = rng.integers(0, self.vocab, size=self.batch, dtype=np.int32)
        noise = rng.random((self.batch, self.seq_len + 1))
        zipf_draws = rng.choice(
            self.vocab, size=(self.batch, self.seq_len + 1), p=self._zipf
        ).astype(np.int32)
        for t in range(self.seq_len + 1):
            out[:, t] = cur
            follow = noise[:, t] < 0.75
            cur = np.where(follow, self._succ[cur], zipf_draws[:, t])
        return out

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def synthetic_ratings(n_users: int, n_items: int, k: int, seed: int = 0):
    """Paper §6.1: U, V ~ N(0,1); R = U V^T.  Returns (U, V, R)."""
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(n_users, k)).astype(np.float32)
    v = rng.normal(size=(n_items, k)).astype(np.float32)
    return u, v, u @ v.T


def movielens_like_ratings(seed: int = 0, n_users: int = 943, n_items: int = 1682,
                           density: float = 0.063, n_clusters: int = 12):
    """§6.2 surrogate with MovieLens100k statistics.

    Returns (rows, cols, vals) of observed ratings in 1..5, with Zipfian item
    popularity and clustered user preferences so learned factors have the
    clustered geometry real MovieLens factors show.
    """
    rng = np.random.default_rng(seed)
    k0 = 8
    centers = rng.normal(size=(n_clusters, k0))
    users = centers[rng.integers(0, n_clusters, n_users)] + 0.4 * rng.normal(
        size=(n_users, k0)
    )
    items = rng.normal(size=(n_items, k0))
    pop = 1.0 / np.arange(1, n_items + 1) ** 0.9
    pop /= pop.sum()
    n_obs = int(density * n_users * n_items)
    rows = rng.integers(0, n_users, n_obs)
    cols = rng.choice(n_items, size=n_obs, p=pop)
    raw = np.sum(users[rows] * items[cols], axis=1)
    raw = (raw - raw.mean()) / (raw.std() + 1e-9)
    vals = np.clip(np.round(3.0 + 1.2 * raw + 0.3 * rng.normal(size=n_obs)), 1, 5)
    # dedupe (user, item) pairs
    key = rows.astype(np.int64) * n_items + cols
    _, first = np.unique(key, return_index=True)
    return rows[first], cols[first], vals[first].astype(np.float32)


def shard_batch(batch: np.ndarray, mesh, axis: str = "data"):
    """Place a host batch onto the mesh, sharded along the batch dim over
    ``axis`` (replicated over the other axes).  Every rank holds the same
    host batch, as in the reference, so each keeps its own rows
    (``DTensor.from_local``) and nothing is sent.  The batch dim must
    divide by the axis's size."""
    import torch
    from torch.distributed.tensor import DTensor, Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    n = mesh.size(names.index(axis))
    x = torch.as_tensor(np.asarray(batch), device=mesh.device_type)
    if x.shape[0] % n:
        raise ValueError(f"batch of {x.shape[0]} rows does not split over "
                         f"the {n} ranks of axis {axis!r}")
    c = mesh.get_local_rank(axis)
    rows = x.shape[0] // n
    pl = [Shard(0) if a == axis else Replicate() for a in names]
    return DTensor.from_local(x[c * rows:(c + 1) * rows].clone(), mesh, pl,
                              run_check=False)
