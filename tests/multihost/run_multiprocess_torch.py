"""Multi-host contract runner of the port: real processes, real collectives.

Counterpart of ``run_multiprocess.py`` for ``repro_torch``.  Spawns N
worker processes (default 2), each joining one ``torch.distributed`` gloo
process group at a shared local coordinator (``repro_torch.launch.procs``),
and drives the SAME SPMD lifecycle on every process:

  build -> query -> upsert/delete -> query -> mark_down(failover) -> query
  -> background compaction (queries mid-flight) -> repartition -> query

After every step, every process asserts that the ``sharded-multihost``
answer is bit-identical (ids, scores, ``n_scored``, discarded fractions) to
an in-process single-host ``sharded`` retriever over the identical catalog,
and on exact queries that its ids equal a ``brute`` retriever's — so the
cross-host all-gather merge, the replica routing and the failover path are
exercised under genuinely separate processes, not just simulated placement.
At ``--replication`` below ``--processes`` a host also holds only its own
slices and must refuse to snapshot.

Usage (tier-1 runs the first through ``tests/test_torch_multihost.py``):

    PYTHONPATH=src python tests/multihost/run_multiprocess_torch.py \\
        --processes 2 --device cpu
    PYTHONPATH=src python tests/multihost/run_multiprocess_torch.py \\
        --processes 2 --items 1048576 --dim 10 --shards 8      # the card

Exit code 0 iff every worker passed every assertion; a worker that hangs
past ``--timeout`` is killed and fails the run (124).
"""
from __future__ import annotations

import argparse
import os
import sys

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..",
                   "src")


def worker(args) -> None:
    sys.path.insert(0, SRC)
    import numpy as np
    import torch.distributed as dist

    from repro_torch.core.mapping import GamConfig
    from repro_torch.launch.procs import init_process_group
    from repro_torch.retriever import (RetrieverSpec, UnsupportedOp,
                                       open_retriever)

    n = args.processes
    init_process_group(args.coordinator, n, args.process_id,
                       timeout_s=args.group_timeout)
    assert dist.get_world_size() == n

    def log(msg: str) -> None:
        if args.process_id == 0:
            print(f"[multihost x{n}] {msg}", flush=True)

    rng = np.random.default_rng(0)  # identical catalog on every process
    k = args.dim
    cfg = GamConfig(k=k, scheme="parse_tree", threshold=0.2)
    items = rng.normal(size=(args.items, k)).astype(np.float32)
    items /= np.linalg.norm(items, axis=1, keepdims=True)
    users = rng.normal(size=(args.queries, k)).astype(np.float32)

    def spec(backend: str, **kw) -> RetrieverSpec:
        return RetrieverSpec(cfg=cfg, backend=backend,
                             n_shards=args.shards, min_overlap=2, **kw)

    def opened(backend: str, **kw):
        return open_retriever(spec(backend, **kw), items=items,
                              device=args.device)

    multi = opened("sharded-multihost", n_hosts=n,
                   replication=args.replication)
    single = opened("sharded")
    oracle = opened("brute")
    assert multi._distributed, "the runner must exercise the process group"
    held = sorted(multi.base.slices) if not multi.base.has_all_slices \
        else list(range(multi.base.placement.n_slices))
    log(f"placement {multi.base.placement.describe()}, host 0 holds "
        f"slices {held}")

    def check(tag: str, exact: bool = False) -> None:
        got = multi.query(users, 10, exact=exact)
        want = single.query(users, 10, exact=exact)
        assert np.array_equal(got.ids, want.ids), tag
        assert np.array_equal(got.scores, want.scores), tag
        assert np.array_equal(got.n_scored, want.n_scored), tag
        assert np.array_equal(got.discarded_frac, want.discarded_frac), tag
        if exact:
            truth = oracle.query(users, 10, exact=True)
            assert np.array_equal(got.ids, truth.ids), f"{tag} (vs brute)"
        log(f"{tag}: bit-identical to single-host sharded")

    check("after build")
    check("after build (exact)", exact=True)

    new = np.random.default_rng(1).normal(size=(12, k)).astype(np.float32)
    fresh = np.arange(args.items + 300, args.items + 312)
    for r in (multi, single, oracle):
        r.upsert(fresh, new)
        r.delete([3, 5, 7, int(fresh[0])])
    check("after upsert+delete")

    if args.replication >= 2:
        multi.mark_down(n - 1)          # SPMD health update on every process
        check("with one host marked down")
        assert multi.host_status()["n_failovers"] >= 1
        multi.mark_up(n - 1)
    else:
        try:
            multi.snapshot(os.devnull)
        except UnsupportedOp:
            log("snapshot refused: no host holds every slice")
        else:
            raise AssertionError("a host without every slice snapshotted")

    for r in (multi, single):
        r.compact(async_=True)
    steps = 0
    while multi.maintenance_stats()["compaction"]["active"]:
        check(f"mid-compaction step {steps}")
        steps += 1
        assert steps < 200, "background compaction never finished"
    while single.maintenance_stats()["compaction"]["active"]:
        single.compaction_step()
    check("after background compaction")

    p_multi = multi.repartition(async_=False)
    p_single = single.repartition(async_=False)
    assert p_multi == p_single, (p_multi, p_single)
    check("after repartition")
    check("after repartition (exact)", exact=True)

    n_slices = multi.host_status()["n_slices"]
    log(f"OK — all multi-process contract checks passed on {n} processes "
        f"(replication={args.replication}, {n_slices} slices, "
        f"device {multi.device})")
    dist.destroy_process_group()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--processes", type=int, default=2)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--items", type=int, default=600)
    ap.add_argument("--dim", type=int, default=16)
    ap.add_argument("--shards", type=int, default=0,
                    help="item-axis shards (0: two per process)")
    ap.add_argument("--replication", type=int, default=2)
    ap.add_argument("--queries", type=int, default=8)
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="deadline of the whole run (stragglers -> 124)")
    ap.add_argument("--group-timeout", type=float, default=120.0,
                    help="the process group's rendezvous and collective "
                         "timeout")
    ap.add_argument("--role", choices=["parent", "worker"], default="parent")
    ap.add_argument("--process-id", type=int, default=0)
    ap.add_argument("--coordinator", default="")
    args = ap.parse_args()
    if not args.shards:
        args.shards = 2 * args.processes
    if not 1 <= args.replication <= args.processes:
        ap.error("--replication must be in [1, --processes]")

    if args.role == "worker":
        worker(args)
        return 0

    sys.path.insert(0, SRC)
    from repro_torch.launch.procs import free_coordinator, run_workers

    coordinator = free_coordinator()
    passed = [f"--{name}={getattr(args, name.replace('-', '_'))}"
              for name in ("processes", "device", "items", "dim", "shards",
                           "replication", "queries", "group-timeout")]
    commands = [[sys.executable, os.path.abspath(__file__), *passed,
                 "--role", "worker", "--process-id", str(i),
                 "--coordinator", coordinator]
                for i in range(args.processes)]
    codes, _ = run_workers(commands, timeout=args.timeout)
    if any(codes):
        print(f"FAILED: worker exit codes {codes}", file=sys.stderr)
        return 1
    print(f"PASSED: {args.processes}-process multihost contract suite "
          f"(replication={args.replication}, device {args.device})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
