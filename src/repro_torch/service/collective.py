"""Cross-host placement, routing and the collective top-kappa merge.

The multi-host serving tier places the repartitioner's per-shard plan onto a
set of host processes: consecutive shards form *placement slices* (one
contiguous run of the id-sorted catalog per slice, balanced by row count),
each slice is replicated onto ``replication`` hosts, and a deterministic
router picks exactly one live replica per slice.  Because every replica is
built from the identical catalog slice by identical deterministic code,
*which* replica answers never changes a result — failover is exact by
construction.

The merge is the collective counterpart of the fused kernel's host merge:
every host exports its local slices' accumulators through
``kernels.gam_retrieve.export_topk`` (O(Q * kappa) f32 scores + int32 global
rows), the accumulators are all-gathered across processes, and
:func:`merge_topk` realises the kernel's (score desc, row asc) total order
over the concatenation — bit-identical to the single-host ``sharded``
backend merging the same shards in one process.

Counterpart of ``repro.service.collective``.  The cross-process gather
(:func:`allgather_accumulators`) runs on ``torch.distributed``: one
``all_gather`` of the host's payloads as a CPU tensor over the gloo
backend.  Single-process deployments (and the tier-1 tests) run the same
code with no process group, where the gather is the identity, so the merge
path is identical in and out of a process group.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels.gam_retrieve import TOPK_EMPTY_ROW
from repro_torch.kernels.gam_score import NEG

__all__ = ["HostPlacement", "NoLiveReplica", "allgather_accumulators",
           "allgather_array", "empty_accumulators", "merge_topk",
           "process_group"]


class NoLiveReplica(RuntimeError):
    """Every replica of a placement slice is marked down — the catalog range
    is unservable and an exact answer is impossible.  Raised eagerly (never
    a silently incomplete result)."""

    def __init__(self, slice_id: int, hosts: tuple[int, ...]):
        self.slice_id = slice_id
        self.hosts = hosts
        super().__init__(
            f"placement slice {slice_id} has no live replica "
            f"(all of hosts {list(hosts)} are marked down)")


@dataclasses.dataclass(frozen=True)
class HostPlacement:
    """Shard-to-host placement with replication.

    ``slices[i] = (s_lo, s_hi)``: placement slice ``i`` serves shards
    ``[s_lo, s_hi)`` of the partition (contiguous, so each slice is one
    contiguous run of the id-sorted flat row space — the property the merge
    order relies on).  ``replicas[i]``: the hosts holding a full copy of
    slice ``i``, primary first; the router serves each slice from the first
    replica not marked down.
    """

    n_hosts: int
    replication: int
    slices: tuple[tuple[int, int], ...]
    replicas: tuple[tuple[int, ...], ...]

    def __post_init__(self):
        if self.n_hosts < 1:
            raise ValueError(f"n_hosts must be >= 1, got {self.n_hosts}")
        if not 1 <= self.replication <= self.n_hosts:
            raise ValueError(f"replication must be in [1, n_hosts="
                             f"{self.n_hosts}], got {self.replication}")
        if len(self.slices) != len(self.replicas):
            raise ValueError("slices and replicas must align")
        prev = 0
        for i, (lo, hi) in enumerate(self.slices):
            if lo != prev or hi <= lo:
                raise ValueError(f"slice {i}: shard runs must be contiguous "
                                 f"and non-empty, got {self.slices}")
            prev = hi
        for i, reps in enumerate(self.replicas):
            if len(set(reps)) != len(reps) or not reps:
                raise ValueError(f"slice {i}: replica hosts must be a "
                                 f"non-empty distinct set, got {reps}")
            if any(not 0 <= h < self.n_hosts for h in reps):
                raise ValueError(f"slice {i}: replica host out of range")

    @property
    def n_slices(self) -> int:
        return len(self.slices)

    @staticmethod
    def from_partition(partition, n_hosts: int,
                       replication: int = 1) -> "HostPlacement":
        """Place a :class:`~repro_torch.service.repartition.Partition` onto
        ``n_hosts`` processes.

        The per-shard plan is the placement unit: shards are cut into
        ``min(n_hosts, n_shards)`` contiguous runs balanced by live row
        count (the same quantile cut the repartitioner uses for shards), so
        a skew-aware partition's short hot shards spread across hosts
        instead of piling onto one.  Slice ``i``'s replicas are hosts
        ``(i + r) % n_hosts`` — deterministic, so every process derives the
        identical placement without communication.
        """
        n_shards = partition.n_shards
        n_slices = max(1, min(n_hosts, n_shards))
        w = np.asarray(partition.lengths, np.float64) + 1.0
        cum = np.cumsum(w)
        targets = cum[-1] * np.arange(1, n_slices) / n_slices
        cuts = np.searchsorted(cum, targets, side="right")
        bounds = np.concatenate([[0], np.clip(cuts, 0, n_shards), [n_shards]])
        # every slice owns >= 1 shard even when the quantile cuts collapse
        # onto one heavy shard (an empty slice would be unroutable dead
        # weight on its hosts): strictly increasing lower bound, feasible
        # upper bound
        for i in range(1, n_slices):
            bounds[i] = min(max(int(bounds[i]), int(bounds[i - 1]) + 1),
                            n_shards - (n_slices - i))
        slices = tuple((int(lo), int(hi))
                       for lo, hi in zip(bounds[:-1], bounds[1:]))
        replication = max(1, min(int(replication), n_hosts))
        replicas = tuple(tuple((i + r) % n_hosts for r in range(replication))
                         for i in range(n_slices))
        return HostPlacement(n_hosts, replication, slices, replicas)

    # ------------------------------------------------------------- routing

    def route(self, down: frozenset | set = frozenset()
              ) -> tuple[int | None, ...]:
        """Serving host per slice: the first replica not in ``down`` (None
        when every replica is down — :meth:`route_strict` raises there)."""
        return tuple(next((h for h in reps if h not in down), None)
                     for reps in self.replicas)

    def route_strict(self, down: frozenset | set = frozenset()
                     ) -> tuple[int, ...]:
        routing = self.route(down)
        for i, h in enumerate(routing):
            if h is None:
                raise NoLiveReplica(i, self.replicas[i])
        return routing            # type: ignore[return-value]

    def slices_of(self, host: int) -> tuple[int, ...]:
        """Slice ids host ``host`` replicates (and may be routed)."""
        return tuple(i for i, reps in enumerate(self.replicas)
                     if host in reps)

    def describe(self) -> dict:
        return {"n_hosts": self.n_hosts, "replication": self.replication,
                "slices": [list(s) for s in self.slices],
                "replicas": [list(r) for r in self.replicas]}


# ----------------------------------------------------------------- merge


def merge_topk(scores: np.ndarray, rows: np.ndarray,
               kappa: int) -> tuple[np.ndarray, np.ndarray]:
    """Merge concatenated exported accumulators under (score desc, row asc).

    ``scores``/``rows``: (Q, M) with M >= kappa, rows already global int32
    with :data:`TOPK_EMPTY_ROW` in empty slots (the ``export_topk``
    contract).  Returns (Q, kappa) — the identical total order the fused
    kernel's on-chip accumulator realises, so merging per-host accumulators
    here is bit-identical to one host merging all shards itself.
    """
    scores = np.asarray(scores, np.float32)
    rows = np.asarray(rows)
    if scores.shape[1] < kappa:
        pad = kappa - scores.shape[1]
        scores = np.pad(scores, ((0, 0), (0, pad)),
                        constant_values=float(NEG))
        rows = np.pad(rows, ((0, 0), (0, pad)),
                      constant_values=int(TOPK_EMPTY_ROW))
    order = np.lexsort((rows, -scores), axis=-1)[:, :kappa]
    return (np.take_along_axis(scores, order, axis=-1),
            np.take_along_axis(rows, order, axis=-1))


def empty_accumulators(q: int, kappa: int) -> tuple[np.ndarray, np.ndarray]:
    """(Q, kappa) all-empty exported accumulators — what a host with no
    routed slice contributes to the gather."""
    return (np.full((q, kappa), NEG, np.float32),
            np.full((q, kappa), int(TOPK_EMPTY_ROW), np.int32))


def process_group() -> tuple[int, int | None]:
    """``(world size, rank)`` of the default ``torch.distributed`` process
    group, or ``(1, None)`` when none is initialised — the counterpart of
    ``jax.process_count()`` / ``jax.process_index()``."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, None


def allgather_array(a: np.ndarray, group=None) -> np.ndarray:
    """(P, *a.shape): every rank's ``a`` (the same shape and dtype on each)
    in rank order, moved as bytes in one ``all_gather`` of CPU tensors over
    ``group`` (default: the default group).  One process: ``a[None]``."""
    import torch.distributed as dist

    a = np.ascontiguousarray(a)
    if not (dist.is_available() and dist.is_initialized()) or \
            dist.get_world_size(group) == 1:
        return a[None]
    mine = torch.from_numpy(a.reshape(-1).view(np.uint8).copy())
    bufs = [torch.empty_like(mine) for _ in range(dist.get_world_size(group))]
    dist.all_gather(bufs, mine, group=group)
    return np.stack([b.numpy().view(a.dtype).reshape(a.shape)
                     for b in bufs])


def allgather_accumulators(scores: np.ndarray, rows: np.ndarray,
                           shard_candidates: np.ndarray,
                           tile_stats: np.ndarray, *, group=None
                           ) -> tuple[np.ndarray, np.ndarray, np.ndarray,
                                      np.ndarray]:
    """All-gather per-host accumulators across the process group.

    Inputs are THIS host's (Q, kappa) exported accumulator (f32 scores,
    int32 global rows), its (Q, S) per-shard candidate counts (zero for
    shards it did not serve) and its (2,) tile-skip statistic
    [skipped-weighted numerator, block total]; outputs are (Q, P * kappa)
    concatenated accumulators plus the global candidate counts and tile
    stats (summed with numpy over the host axis — the router serves every
    slice exactly once, so the sums are exact and the same bits on every
    host).  With no process group, or one process: the identity.

    The four payloads travel as one int32 CPU tensor (the f32 ones by their
    bits) in one ``all_gather`` over the group's backend, which must move
    CPU tensors (gloo: NCCL refuses two ranks on one card, and the payload
    is O(Q * kappa) — about 20 KB a host at Q 256, kappa 10).  ``group``:
    a subgroup to gather over (a mesh axis's) instead of the default group.
    """
    import torch.distributed as dist

    world = (dist.get_world_size(group) if group is not None
             else process_group()[0])
    if world == 1:
        return scores, rows, shard_candidates, tile_stats

    s = np.ascontiguousarray(scores, np.float32)
    r = np.ascontiguousarray(rows, np.int32)
    c = np.ascontiguousarray(shard_candidates, np.int32)
    t = np.ascontiguousarray(tile_stats, np.float32)
    parts = (s.view(np.int32), r, c, t.view(np.int32))
    mine = torch.from_numpy(np.concatenate([p.ravel() for p in parts]))
    bufs = [torch.empty_like(mine) for _ in range(world)]
    dist.all_gather(bufs, mine, group=group)
    flat = torch.stack(bufs).numpy()                   # (P, payload)
    cuts = np.cumsum([p.size for p in parts])[:-1]
    g_s, g_r, g_c, g_t = np.split(flat, cuts, axis=1)
    q, kappa = s.shape
    g_s = np.ascontiguousarray(g_s).view(np.float32).reshape(world, q, kappa)
    g_r = g_r.reshape(world, q, kappa)
    cat_s = g_s.transpose(1, 0, 2).reshape(q, world * kappa)
    cat_r = g_r.transpose(1, 0, 2).reshape(q, world * kappa)
    return (cat_s, cat_r, g_c.reshape((world,) + c.shape).sum(axis=0),
            np.ascontiguousarray(g_t).view(np.float32).sum(axis=0))
