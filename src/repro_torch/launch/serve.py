"""Serving launcher of the port: batched generation with optional
GAM-accelerated head, or (with ``--service``) the sharded streaming
retrieval service — single-process, or spanning real host processes with
``--hosts N``.  Counterpart of ``repro.launch.serve``, with the same flags
and one more: ``--device {cuda,cpu}`` (default ``cuda``; without a card
the launcher raises unless given ``--device cpu``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch olmo-1b \
      --reduced --batch 4 --prompt-len 16 --new-tokens 24 --gam

  PYTHONPATH=src python -m repro_torch.launch.serve --service \
      --items 2000 --dim 16 --shards 2 --requests 64 --service-batch 8

  PYTHONPATH=src python -m repro_torch.launch.serve --service --hosts 2 \
      --replication 2 --items 2000 --shards 4 [--fail-host 1]

``--hosts N`` spawns N local worker processes, joins them into one
``torch.distributed`` process group (gloo: the accumulators travel as CPU
tensors; on a one-card machine the workers share the card) and serves the
catalog from the ``sharded-multihost`` backend: every worker drives the
identical SPMD request stream, each computes only the placement slices
routed to it, and the top-kappa accumulators merge through the cross-host
collective.  ``--fail-host H`` marks host H down halfway through the
stream to demonstrate exact failover onto the surviving replicas.
"""
from __future__ import annotations

import argparse
import importlib
import sys
import time

import numpy as np

from repro_torch.configs.registry import (ARCH_IDS, get_config,
                                          get_reduced_config)
from repro_torch.device import resolve_device


def _kernel_launches(*names: str) -> dict:
    """Launches of the named CUDA kernels in this process so far (each
    wrapper counts its own; on the CPU ``ops`` runs the plain versions and
    the counts stay 0)."""
    return {name: getattr(importlib.import_module(
        f"repro_torch.kernels.{name}"), name).launches for name in names}


def _trace_options(args) -> tuple:
    """Spec options carrying the tracing knobs (empty when tracing is off,
    so specs stay byte-identical to pre-observability ones)."""
    if not args.trace_sample:
        return ()
    return (("trace_sample", args.trace_sample),)


def _qos_policy(args):
    """A QosPolicy from the CLI knobs (the default is the no-op policy, so
    runs without QoS flags behave exactly as before)."""
    from repro_torch.service.qos import QosPolicy
    kw = {"breaker_failures": args.breaker_failures}
    if args.queue_cap:
        kw["queue_caps"] = (args.queue_cap,)
    if args.deadline_ms:
        kw["deadlines_s"] = (args.deadline_ms * 1e-3,)
    if args.hedge_factor:
        kw["hedge_factor"] = args.hedge_factor
    return QosPolicy(**kw)


def _fault_injector(args):
    from repro_torch.service.faults import FaultInjector
    return (FaultInjector(args.inject_faults, seed=args.fault_seed)
            if args.inject_faults else None)


def _guarded_query(svc, users, deadline_s=None):
    """One query round that survives unservable rounds: a
    :class:`~repro.service.collective.NoLiveReplica` (every replica of some
    slice down or faulted) becomes a typed, counted shed and the server
    keeps serving — later rounds may succeed after a probe closes the
    breaker.  Returns the RetrievalResult, or None for a shed round."""
    from repro_torch.service.collective import NoLiveReplica
    try:
        return svc.query(users, deadline_s=deadline_s)
    except NoLiveReplica as e:
        svc.metrics.record_shed("no_live_replica")
        svc.events.emit("request_shed", reason="no_live_replica",
                        slice=e.slice_id)
        return None


def _open_metrics_writer(args, suffix: str = ""):
    """A periodic JSON-lines metrics writer for ``--metrics-out`` (None when
    the flag is absent or names a ``.prom`` file — Prometheus text is a
    point-in-time exposition, written once at exit)."""
    if not args.metrics_out or args.metrics_out.endswith(".prom"):
        return None
    from repro_torch.obs.exporters import JsonlMetricsWriter
    return JsonlMetricsWriter(args.metrics_out + suffix, interval_s=0.25)


def _finish_observability(args, svc, writer, suffix: str = "") -> None:
    """Final ``--metrics-out`` / ``--trace-out`` dump after the stream."""
    if args.metrics_out:
        if writer is not None:
            writer.write(svc.metrics.snapshot(), svc.metrics.histograms())
            print(f"metrics (jsonl) -> {writer.path}")
        else:
            from repro_torch.obs.exporters import snapshot_to_prometheus
            path = args.metrics_out + suffix
            with open(path, "w") as f:
                f.write(snapshot_to_prometheus(svc.metrics.snapshot(),
                                               svc.metrics.histograms()))
            print(f"metrics (prometheus) -> {path}")
    if args.trace_out:
        export = getattr(svc.tracer, "export_jsonl", None)
        if export is None:
            print("--trace-out ignored: tracing is off "
                  "(pass --trace-sample > 0)")
        else:
            path = args.trace_out + suffix
            n = export(path)
            st = svc.tracer.stats()
            print(f"traces -> {path} ({n} roots; sampled "
                  f"{st['n_sampled']}/{st['n_started']})")


def _learn_setup(args, svc, items):
    """``--learn`` wiring: a StreamingMF + PushPolicy pair over either the
    seeded drift simulator or a JSONL events file (``--learn-events``).
    Returns ``(trainer, policy, sim, event_rounds)``."""
    from repro_torch.online import (EventBatch, OnlineMFConfig, PushPolicy,
                              StreamingMF)

    policy = PushPolicy(svc, min_cos=args.push_min_cos,
                        staleness_s=args.push_staleness_s)
    policy.seed(np.arange(items.shape[0]), items)
    n_rounds = max(args.requests // max(args.learn_interval, 1), 1)
    if args.learn_events:
        feed = EventBatch.from_jsonl(args.learn_events)
        trainer = StreamingMF(OnlineMFConfig(k=args.dim, lr=0.5,
                                             momentum=0.6, seed=1),
                              device=args.device)
        trainer.warm_start(v=items)
        # timestamp-ordered replay, one contiguous slice per learn round
        per = max(len(feed) // n_rounds, 1)
        rounds = [EventBatch(feed.ts[s:s + per], feed.users[s:s + per],
                             feed.items[s:s + per], feed.values[s:s + per])
                  for s in range(0, len(feed), per)]
        return trainer, policy, None, rounds
    sim = args.learn_sim
    trainer = StreamingMF(OnlineMFConfig(k=args.dim, lr=0.5, momentum=0.6,
                                         seed=1, update_users=False),
                          device=args.device)
    trainer.warm_start(u=sim.users, v=items)
    return trainer, policy, sim, None


def serve_retrieval(args):
    """Open a unified-API retriever (default backend: the sharded streaming
    service), stream upserts + microbatched queries, print the
    ServiceMetrics snapshot (QPS, p50/p99 latency, occupancy, discard,
    shard balance), and optionally snapshot/restore the catalog.

    ``--auto-compact N`` starts a BACKGROUND compaction whenever the delta
    segment holds >= N rows (subsequent queries each advance one bounded
    slice until the atomic swap); ``--rebalance S`` triggers a skew-aware
    repartition when the metrics' per-shard candidate skew (max/mean)
    exceeds S.  ``--learn`` interleaves online factor learning: every
    ``--learn-interval`` requests one event round feeds
    ``StreamingMF.partial_fit`` and the re-trained factors go through the
    angular-drift-gated ``PushPolicy`` into live upserts.

    ``--load-profile`` swaps the fresh-random request stream for the
    seeded production-traffic harness (``repro.service.loadgen``):
    Zipf-popular reusable query identities, Zipf item-popularity upserts
    and diurnal/bursty arrival pacing.  ``--cache N`` enables the exact
    hot-query result cache (N rows) — under a skewed profile the hit rate
    and its latency effect show up in the final metrics line."""
    from repro_torch.core.mapping import GamConfig
    from repro_torch.retriever import RetrieverSpec, open_retriever
    from repro_torch.service.faults import FaultInjected
    from repro_torch.service.microbatch import QueryResult
    from repro_torch.service.qos import RequestShed

    rng = np.random.default_rng(0)
    learn = bool(args.learn or args.learn_events)
    args.learn_sim = None
    if learn and not args.learn_events:
        from repro_torch.online import DriftSimulator
        args.learn_sim = DriftSimulator(n_users=64, n_items=args.items,
                                        k=args.dim, seed=2, drift=args.drift)
        items = args.learn_sim.items_at_start
    else:
        items = rng.normal(size=(args.items, args.dim)).astype(np.float32)
        items /= np.linalg.norm(items, axis=1, keepdims=True)
    cfg = GamConfig(k=args.dim, scheme="parse_tree",
                    threshold=args.gam_item_threshold)
    spec = RetrieverSpec(
        cfg=cfg, backend="sharded", n_shards=args.shards,
        min_overlap=args.gam_min_overlap, kappa=args.kappa,
        batch_size=args.service_batch, max_delay_s=args.max_delay_ms * 1e-3,
        cache_capacity=args.cache,
        cache_ttl_s=args.cache_ttl_s if args.cache_ttl_s > 0 else None,
        options=_trace_options(args))
    qos_on = bool(args.queue_cap or args.deadline_ms)
    svc = open_retriever(spec, items=items, qos=_qos_policy(args),
                         faults=_fault_injector(args), device=args.device)
    writer = _open_metrics_writer(args)
    loadgen = arrivals = None
    if args.load_profile:
        from repro_torch.service.loadgen import LoadGenerator, LoadProfile
        loadgen = LoadGenerator(LoadProfile.parse(args.load_profile),
                                args.dim, item_ids=np.arange(args.items))
        arrivals = loadgen.arrivals(args.requests)

    # one warm-up request (the first launch of each kernel loads its
    # library), then restart the clock: index build and warm-up are
    # excluded from QPS/latency
    svc.query(rng.normal(size=(args.service_batch, args.dim))
              .astype(np.float32))
    svc.metrics.reset()

    trainer = policy = sim = event_rounds = None
    if learn:
        trainer, policy, sim, event_rounds = _learn_setup(args, svc, items)
    learn_rounds = 0
    pending = []
    n_rejected = n_upsert_faults = 0
    try:
        for r in range(args.requests):
            if loadgen is not None:       # Zipf-popular reusable identity
                user = loadgen.sample_queries(1)[1][0]
            else:
                user = rng.normal(size=args.dim).astype(np.float32)
            try:
                # with QoS on, alternate priority classes so the coalescing
                # and per-class shed accounting are visible in the demo
                pending.append(svc.batcher.submit(
                    user, priority=r % 2 if qos_on else 0))
            except RequestShed:
                n_rejected += 1            # admission control said no
            if learn and r % args.learn_interval == args.learn_interval - 1:
                ev = (sim.step() if sim is not None
                      else (event_rounds[learn_rounds]
                            if learn_rounds < len(event_rounds) else None))
                if ev is not None and len(ev):
                    st = trainer.partial_fit(ev)
                    touched = st["touched_items"]
                    policy.offer(touched, trainer.item_factors(touched))
                    try:
                        policy.flush()
                    except FaultInjected:
                        n_upsert_faults += 1   # batch stays pending; retried
                    learn_rounds += 1
            elif r % 16 == 15:                 # interleave streamed upserts
                try:
                    if loadgen is not None:    # Zipf item-popularity churn
                        up_ids, up_fac = loadgen.sample_upserts(1)
                        svc.upsert(up_ids, up_fac)
                    else:
                        svc.upsert([args.items + r],
                                   rng.normal(size=(1, args.dim))
                                   .astype(np.float32))
                except FaultInjected:
                    n_upsert_faults += 1   # injected delta-apply error
            # diurnal/bursty pacing: requests whose arrivals share one
            # max-delay window submit back-to-back (denser batches at the
            # peaks), the poll lands at the window edge
            if arrivals is not None and r + 1 < args.requests:
                win = max(args.max_delay_ms * 1e-3, 1e-6)
                if int(arrivals[r + 1] / win) == int(arrivals[r] / win):
                    continue
            svc.batcher.poll()
            # maintenance triggers: mechanism on the retriever, policy here
            if args.auto_compact and len(svc.delta) >= args.auto_compact:
                svc.compact(async_=True)
            if args.rebalance:
                svc.maybe_rebalance(args.rebalance)
            if writer is not None:
                writer.maybe_write(svc.metrics.snapshot,
                                   svc.metrics.histograms)
        while svc.batcher.pending:
            svc.batcher.flush()
        # drain a still-running background build so the demo exits compacted
        while svc.maintenance_stats()["compaction"]["active"]:
            svc.compaction_step()
    except Exception:
        # flight-recorder dump: the recent lifecycle events, oldest first
        print(f"--- event journal ({len(svc.events)} events) ---",
              file=sys.stderr)
        svc.events.dump_jsonl(sys.stderr)
        raise
    outcomes = [svc.batcher.result(p) for p in pending]
    served = sum(isinstance(o, QueryResult) for o in outcomes)
    n_shed = (sum(isinstance(o, RequestShed) for o in outcomes)
              + n_rejected)
    n_degraded = sum(isinstance(o, QueryResult) and o.degraded
                     for o in outcomes)

    snap = svc.metrics.snapshot()
    print(f"service: {args.items}+{snap['n_upserts']} items, "
          f"{args.shards} shards, batch={args.service_batch}")
    print(f"served {served}/{args.requests} requests in "
          f"{snap['elapsed_s']:.2f}s  ({snap['qps']:.1f} QPS)")
    if qos_on or args.inject_faults:
        print(f"qos: shed={n_shed} "
              f"(queue_full={snap['shed_queue_full']}, "
              f"deadline={snap['shed_deadline']}, "
              f"no_live_replica={snap['shed_no_live_replica']})  "
              f"degraded={n_degraded}  evicted={snap['evicted_total']}  "
              f"upsert faults={n_upsert_faults}")
    print(f"latency p50={snap['latency_p50_ms']:.2f}ms "
          f"p99={snap['latency_p99_ms']:.2f}ms  "
          f"occupancy={snap['occupancy_mean']:.2f}")
    if args.cache:
        cs = svc.cache.stats()
        hr = cs["hit_rate"]
        print(f"cache: {cs['hits']} hits / {cs['misses']} misses "
              f"(rate {'n/a' if hr is None else f'{hr:.1%}'})  "
              f"evictions={cs['evictions']}  "
              f"invalidations={cs['invalidations']}  "
              f"size={cs['size']}/{cs['capacity']}")
    balance = snap["shard_balance"]
    print(f"discard={snap['discard_mean']:.1%}  "
          f"shard balance (max/mean candidates)="
          f"{'n/a (window reset)' if balance is None else f'{balance:.2f}'}")
    if args.auto_compact or args.rebalance:
        ms = svc.maintenance_stats()
        print(f"maintenance: generation={ms['generation']}  "
              f"async compactions={snap['n_async_compactions']} "
              f"({snap['n_compact_slices']} slices)  "
              f"repartitions={snap['n_repartitions']}  "
              f"shard bns={ms['repartition']['partition']['bns']}")
    if learn:
        # land anything still pending (staleness clocks notwithstanding)
        policy.flush(force=True)
        snap = svc.metrics.snapshot()
        ts = trainer.stats()
        ps = policy.stats()
        p50 = snap["push_staleness_p50_s"]
        print(f"learn: {learn_rounds} rounds, {ts['n_events']} events, "
              f"{ts['n_items']} items ({ts['n_grows']} capacity grows), "
              f"mse={ts['mse']:.4f}")
        print(f"push: {snap['push_total']} pushed, "
              f"{snap['push_suppressed']} suppressed "
              f"(rate {ps['suppression_rate']:.0%}), staleness "
              f"p50={'n/a' if p50 is None else f'{p50 * 1e3:.1f}ms'}")
        if sim is not None:
            eval_users = sim.users[:16]
            got = svc.query(eval_users, args.kappa, exact=True)
            rec = sim.recall(got.ids, sim.true_topk(args.kappa, eval_users))
            print(f"learn: recall@{args.kappa} vs drifted truth = {rec:.2f} "
                  f"(index tracks {sim.round} rounds of drift)")
    print(f"kernel launches: "
          f"{_kernel_launches('gam_retrieve', 'tess_project')}")
    _finish_observability(args, svc, writer)

    if args.snapshot:
        svc.snapshot(args.snapshot)
        restored = open_retriever(spec, snapshot=args.snapshot,
                                  device=args.device)
        probe = rng.normal(size=(4, args.dim)).astype(np.float32)
        a, b = svc.query(probe), restored.query(probe)
        if not (np.array_equal(a.ids, b.ids)
                and np.array_equal(a.scores, b.scores)):
            raise SystemExit("FAILED: the restored snapshot answers "
                             "differently")
        print(f"snapshot -> {args.snapshot}  "
              f"(restored {restored.n_items} items, delta="
              f"{len(restored.delta)}; probe queries bit-identical)")


def _spawn_hosts(args) -> int:
    """Parent half of ``--hosts N``: spawn N copies of this launcher as
    worker processes sharing one local coordinator, and aggregate their
    exit codes (demo/CI — a real deployment launches one worker per
    machine with the same flags)."""
    from repro_torch.launch.procs import free_coordinator, run_workers

    coordinator = free_coordinator()
    codes, _ = run_workers(
        [[sys.executable, "-m", "repro_torch.launch.serve", *sys.argv[1:],
          "--host-id", str(i), "--coordinator", coordinator]
         for i in range(args.hosts)])
    if any(codes):
        print(f"FAILED: host exit codes {codes}", file=sys.stderr)
        return 1
    return 0


def serve_retrieval_multihost(args):
    """SPMD worker body of ``--hosts N``: every process runs this function
    with identical arguments, so catalogs, mutations and queries line up
    across the mesh (the microbatcher front-end stays out of the loop —
    its deadline coalescing is wall-clock dependent and would diverge)."""
    from repro_torch.core.mapping import GamConfig
    from repro_torch.retriever import RetrieverSpec, open_retriever
    from repro_torch.service.faults import FaultInjected

    import torch.distributed as dist

    from repro_torch.launch.procs import init_process_group

    init_process_group(args.coordinator, args.hosts, args.host_id)
    me = dist.get_rank()

    rng = np.random.default_rng(0)       # same catalog on every host
    items = rng.normal(size=(args.items, args.dim)).astype(np.float32)
    items /= np.linalg.norm(items, axis=1, keepdims=True)
    cfg = GamConfig(k=args.dim, scheme="parse_tree",
                    threshold=args.gam_item_threshold)
    spec = RetrieverSpec(
        cfg=cfg, backend="sharded-multihost", n_shards=args.shards,
        n_hosts=args.hosts, replication=args.replication,
        min_overlap=args.gam_min_overlap, kappa=args.kappa,
        batch_size=args.service_batch,
        # per-host result caches; TTL stays None under SPMD so every host
        # makes identical hit/miss decisions (wall-clock expiry diverges)
        cache_capacity=args.cache,
        options=_trace_options(args))
    lg = None
    if args.load_profile:
        # seeded, so every SPMD host draws the identical Zipf stream
        from repro_torch.service.loadgen import LoadGenerator, LoadProfile
        lg = LoadGenerator(LoadProfile.parse(args.load_profile), args.dim,
                           item_ids=np.arange(args.items))
    # the injector is seeded, so every SPMD process draws the same fates
    # and the chaos (stalls, breaker trips, reroutes) stays collective
    fi = _fault_injector(args)
    svc = open_retriever(spec, items=items, qos=_qos_policy(args), faults=fi,
                         device=args.device)
    # per-host artifact files; same tracer seed everywhere, so the h*.jsonl
    # files share trace ids and reassemble into cross-host traces
    writer = _open_metrics_writer(args, suffix=f".h{me}")

    bs = args.service_batch
    warm = rng.normal(size=(bs, args.dim)).astype(np.float32)
    svc.query(warm)                       # exclude warm-up from the clock
    svc.metrics.reset()

    n_batches = max(1, args.requests // bs)
    deadline_s = args.deadline_ms * 1e-3 if args.deadline_ms else None
    lat = []
    n_shed_rounds = n_degraded = n_wrong = n_verified = n_upsert_faults = 0
    try:
        for b in range(n_batches):
            users = (lg.sample_queries(bs)[1] if lg is not None else
                     rng.normal(size=(bs, args.dim)).astype(np.float32))
            if args.fail_host is not None and b == n_batches // 2:
                svc.mark_down(args.fail_host)
            if b % 4 == 3:                    # interleaved SPMD upserts
                try:
                    if lg is not None:
                        up_ids, up_fac = lg.sample_upserts(1)
                        svc.upsert(up_ids, up_fac)
                    else:
                        svc.upsert([args.items + b],
                                   rng.normal(size=(1, args.dim))
                                   .astype(np.float32))
                except FaultInjected:
                    # raised before any mutation, and identically on every
                    # host (same seeded draw) — the delta stays consistent
                    n_upsert_faults += 1
            t0 = time.perf_counter()
            got = _guarded_query(svc, users, deadline_s=deadline_s)
            lat.append(time.perf_counter() - t0)
            if got is None:
                n_shed_rounds += 1            # typed shed; keep serving
                continue
            n_degraded += bool(got.degraded)
            if args.verify and not got.degraded:
                # ground truth = the same SPMD query with faults off; an
                # answer under chaos must be the same bits (replica
                # exactness), else it counts as WRONG
                svc.faults = None
                want = svc.query(users)
                svc.faults = fi
                n_verified += 1
                if not (np.array_equal(got.ids, want.ids)
                        and np.array_equal(got.scores, want.scores)):
                    n_wrong += 1
            # feed the skew signal (the microbatcher does this on the
            # single-host path); the gathered per-shard candidate counts are
            # identical on every host, so the rebalance trigger stays SPMD
            svc.record_last_query_stats()
            if args.auto_compact and len(svc.delta) >= args.auto_compact:
                svc.compact(async_=True)
            if args.rebalance:
                svc.maybe_rebalance(args.rebalance)
            if writer is not None:
                writer.maybe_write(svc.metrics.snapshot,
                                   svc.metrics.histograms)
        while svc.maintenance_stats()["compaction"]["active"]:
            svc.compaction_step()
    except Exception:
        print(f"--- host {me} event journal ({len(svc.events)} events) ---",
              file=sys.stderr)
        svc.events.dump_jsonl(sys.stderr)
        raise

    if me == 0:
        ms = svc.maintenance_stats()
        hosts = ms["hosts"]
        lat_ms = np.asarray(lat) * 1e3
        print(f"multihost service: {args.items} items, {args.shards} shards "
              f"on {args.hosts} hosts (replication={args.replication}, "
              f"{hosts['n_slices']} slices)")
        if args.rebalance:
            print(f"rebalance: {ms['repartition']['n_repartitions']} "
                  f"repartitions (threshold {args.rebalance})")
        print(f"served {n_batches * bs} requests  "
              f"p50={np.percentile(lat_ms, 50):.2f}ms "
              f"p99={np.percentile(lat_ms, 99):.2f}ms")
        if args.cache:
            cs = svc.cache.stats()
            hr = cs["hit_rate"]
            print(f"cache (per host): {cs['hits']} hits / "
                  f"{cs['misses']} misses "
                  f"(rate {'n/a' if hr is None else f'{hr:.1%}'})")
        print(f"routing={hosts['routing']}  down={hosts['down']}  "
              f"failovers={hosts['n_failovers']}  "
              f"host load={hosts['host_load']}")
        if args.inject_faults:
            snap = svc.metrics.snapshot()
            print(f"chaos: {fi.stats()}")
            print(f"chaos: shed rounds={n_shed_rounds}  "
                  f"degraded={n_degraded}  upsert faults={n_upsert_faults}  "
                  f"breaker open/probe/close="
                  f"{snap['breaker_opens']}/{snap['breaker_probes']}/"
                  f"{snap['breaker_closes']}  "
                  f"hedges={snap['hedge_issued']}")
        if args.verify:
            print(f"verify: {n_verified} rounds bit-identical to fault-free "
                  f"re-execution, {n_wrong} WRONG "
                  f"({n_shed_rounds} shed, {n_degraded} degraded)")
    # one write, flushed now: the hosts share the launcher's stdout
    print(f"host {me} kernel launches: "
          f"{_kernel_launches('gam_retrieve', 'tess_project')}", flush=True)
    if args.verify and n_wrong:
        print(f"FAILED: host {me} saw {n_wrong} wrong answers under faults",
              file=sys.stderr)
        sys.exit(1)
    _finish_observability(args, svc, writer, suffix=f".h{me}")
    if args.snapshot and args.replication != args.hosts:
        # the backend would raise UnsupportedOp (no host holds every
        # placement slice) — say so instead of silently dropping the flag
        if me == 0:
            print(f"--snapshot skipped: requires --replication == --hosts "
                  f"(got {args.replication} != {args.hosts}) so one host "
                  f"holds every placement slice")
    elif args.snapshot:
        # SPMD snapshot demo: host 0 writes (it holds every slice), a
        # barrier publishes the file, then EVERY host restores and probes
        # (queries are collective — all processes must participate)
        if me == 0:
            svc.snapshot(args.snapshot)
        dist.barrier()
        restored = open_retriever(spec, snapshot=args.snapshot,
                                  device=args.device)
        probe = rng.normal(size=(4, args.dim)).astype(np.float32)
        a, b = svc.query(probe), restored.query(probe)
        if not (np.array_equal(a.ids, b.ids)
                and np.array_equal(a.scores, b.scores)):
            raise SystemExit(f"FAILED: host {me}: the restored snapshot "
                             "answers differently")
        if me == 0:
            print(f"snapshot -> {args.snapshot} (probe bit-identical)")
    dist.destroy_process_group()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="olmo-1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--gam", action="store_true",
                    help="use the GAM-accelerated LM head")
    ap.add_argument("--gam-threshold", type=float, default=1.5)
    ap.add_argument("--gam-min-overlap", type=int, default=2)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--vocab", type=int)
    # retrieval-service mode
    ap.add_argument("--service", action="store_true",
                    help="run the sharded streaming retrieval service demo")
    ap.add_argument("--items", type=int, default=2000)
    ap.add_argument("--dim", type=int, default=16)
    ap.add_argument("--shards", type=int, default=2)
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--kappa", type=int, default=10)
    ap.add_argument("--service-batch", type=int, default=8)
    ap.add_argument("--max-delay-ms", type=float, default=2.0)
    ap.add_argument("--gam-item-threshold", type=float, default=0.2)
    ap.add_argument("--cache", type=int, default=0, metavar="N",
                    help="hot-query result cache capacity in rows (0 = "
                         "off): exact per-row top-kappa memos, invalidated "
                         "on every catalog mutation via generation tags — "
                         "a hit skips the kernel AND the request queue")
    ap.add_argument("--cache-ttl-s", type=float, default=0.0, metavar="S",
                    help="optional result-cache entry age-out in seconds "
                         "(0 = no TTL; ignored under --hosts > 1, where "
                         "wall-clock expiry would desync the SPMD hosts)")
    ap.add_argument("--load-profile", metavar="SPEC",
                    help="production-traffic harness, e.g. 'zipf=1.1,"
                         "curve=diurnal,qps=500,peak=4,period=30': Zipf-"
                         "popular reusable query identities, Zipf item-"
                         "popularity upserts, diurnal/bursty arrival "
                         "pacing (see docs/load_testing.md)")
    ap.add_argument("--hosts", type=int, default=1, metavar="N",
                    help="serve from N host processes (sharded-multihost "
                         "backend over a torch.distributed gloo group; "
                         "spawns N local workers for demo/CI)")
    ap.add_argument("--replication", type=int, default=1, metavar="R",
                    help="replicas per placement slice (failover capacity)")
    ap.add_argument("--fail-host", type=int, default=None, metavar="H",
                    help="mark host H down halfway through the stream "
                         "(demonstrates exact failover)")
    ap.add_argument("--host-id", type=int, default=None,
                    help=argparse.SUPPRESS)     # worker-internal
    ap.add_argument("--coordinator", default=None,
                    help=argparse.SUPPRESS)     # worker-internal
    ap.add_argument("--auto-compact", type=int, default=0, metavar="N",
                    help="start a background compaction whenever the delta "
                         "segment reaches N rows (0 = never)")
    ap.add_argument("--rebalance", type=float, default=0.0, metavar="SKEW",
                    help="repartition when per-shard candidate skew "
                         "(max/mean) exceeds SKEW (0 = never)")
    ap.add_argument("--snapshot", metavar="PATH",
                    help="after serving, snapshot the catalog there and "
                         "verify a restore answers bit-identically")
    ap.add_argument("--metrics-out", metavar="PATH",
                    help="export service metrics: *.prom writes Prometheus "
                         "text at exit, any other path appends periodic "
                         "JSON-lines snapshots during the stream "
                         "(multi-host runs suffix .hN per host)")
    ap.add_argument("--trace-out", metavar="PATH",
                    help="export sampled request traces as JSON-lines at "
                         "exit (needs --trace-sample > 0; multi-host runs "
                         "suffix .hN per host)")
    ap.add_argument("--trace-sample", type=float, default=0.0,
                    metavar="RATE",
                    help="probability of tracing a request batch end-to-end "
                         "(0 = tracing off, its default noop path)")
    # online learning (repro.online: StreamingMF + PushPolicy)
    ap.add_argument("--learn", action="store_true",
                    help="interleave online factor learning: the seeded "
                         "drift simulator feeds StreamingMF.partial_fit "
                         "and re-trained factors reach the index through "
                         "the angular-drift-gated PushPolicy")
    ap.add_argument("--learn-events", metavar="PATH",
                    help="replay implicit-feedback events from a JSONL "
                         "file (ts/user/item/value per line) instead of "
                         "the simulator; implies --learn")
    ap.add_argument("--learn-interval", type=int, default=16, metavar="N",
                    help="ingest one event round every N requests")
    ap.add_argument("--push-min-cos", type=float, default=0.98,
                    metavar="COS",
                    help="angular push gate: upsert a re-trained factor "
                         "when cos(new, last pushed) drops below COS")
    ap.add_argument("--push-staleness-s", type=float, default=2.0,
                    metavar="S",
                    help="staleness budget: push a dirty factor after S "
                         "seconds even below the angular gate")
    ap.add_argument("--drift", type=float, default=0.1, metavar="D",
                    help="simulator per-round drift step on hot items")
    # QoS + chaos knobs
    ap.add_argument("--queue-cap", type=int, default=0, metavar="N",
                    help="admission control: shed submits past N queued "
                         "requests per priority class (0 = unbounded)")
    ap.add_argument("--deadline-ms", type=float, default=0.0, metavar="MS",
                    help="per-request deadline; expired requests shed, "
                         "tight ones answer degraded (flagged) down the "
                         "degrade ladder (0 = none)")
    ap.add_argument("--hedge-factor", type=float, default=0.0, metavar="F",
                    help="hedged reads: re-issue a slice when the serving "
                         "replica runs past F x its own p99 (0 = off; "
                         "single-process placement only)")
    ap.add_argument("--breaker-failures", type=int, default=3, metavar="K",
                    help="circuit breaker: auto-mark_down a host after K "
                         "consecutive observed failures")
    ap.add_argument("--inject-faults", metavar="SPEC",
                    help="live fault injection, e.g. "
                         "'stall=0.1,drop=0.05,slow=0.2:0.02,"
                         "delta_error=0.01,hosts=1' (seeded; SPMD-"
                         "deterministic across hosts)")
    ap.add_argument("--fault-seed", type=int, default=0,
                    help="seed for --inject-faults (default 0)")
    ap.add_argument("--verify", action="store_true",
                    help="multihost: re-run every non-degraded round with "
                         "faults disabled and require bit-identical "
                         "answers (exits 1 on any wrong answer)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the index, the model and the kernels run "
                         "(default: the card; cpu runs the plain PyTorch "
                         "versions; passed on to --hosts workers)")
    args = ap.parse_args()
    # the card unless asked for the CPU: raises here, before any worker is
    # spawned or any catalog built, when there is no card
    resolve_device(args.device)

    if (args.learn or args.learn_events) and args.hosts > 1:
        ap.error("--learn runs on the single-host service loop "
                 "(--hosts 1); the SPMD stream has no trainer yet")
    if (args.learn or args.learn_events) and not args.service:
        ap.error("--learn requires --service")
    if args.service and args.hosts > 1:
        if args.fail_host is not None:
            # fail fast (not NoLiveReplica tracebacks halfway through the
            # stream): failing a host needs a surviving replica, and the
            # failed host must exist
            if args.replication < 2:
                ap.error("--fail-host needs --replication >= 2 (a failed "
                         "host's slices must have a surviving replica)")
            if not 0 <= args.fail_host < args.hosts:
                ap.error(f"--fail-host {args.fail_host} out of range "
                         f"[0, {args.hosts})")
        if args.host_id is None:
            sys.exit(_spawn_hosts(args))
        serve_retrieval_multihost(args)
        return
    if args.service:
        serve_retrieval(args)
        return

    serve_lm(args)


def serve_lm(args):
    """The LM mode: seeded random weights, one ``Engine.generate`` call, for
    every family of the registry.  The inputs are the reference's, drawn
    from one numpy rng seeded 0: prompt tokens, then for ``encdec`` frame
    embeddings (4 frames a prompt token) and for ``vlm`` image embeddings.
    ``use_decode_kernel`` is set, so the decode step attends through the
    ``decode_attention`` kernel wherever the reference's decode takes the
    kernel branch (GQA without ring or window: the dense, MoE, encdec and
    vlm families; its plain version on the CPU).  The cache holds the image
    prefix too: capacity is prefix + prompt + new tokens + 8."""
    from repro_torch.models.model import Model
    from repro_torch.serving import Engine, ServeConfig

    cfg = get_reduced_config(args.arch) if args.reduced else get_config(
        args.arch)
    if args.vocab:
        cfg = cfg.with_(vocab=args.vocab)
    cfg = cfg.with_(use_decode_kernel=True)
    model = Model(cfg, device=args.device)
    params = model.init(0)
    eng = Engine(cfg, params, ServeConfig(
        max_new_tokens=args.new_tokens,
        temperature=args.temperature,
        use_gam_head=args.gam,
        gam_threshold=args.gam_threshold,
        gam_min_overlap=args.gam_min_overlap,
    ), capacity=model.n_prefix() + args.prompt_len + args.new_tokens + 8,
        device=args.device)

    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab,
                                    (args.batch, args.prompt_len))}
    if cfg.family == "encdec":
        batch["frames"] = rng.normal(size=(
            args.batch, args.prompt_len * 4, cfg.d_frontend)).astype(
                np.float32)
    if cfg.family == "vlm":
        batch["image_embeds"] = rng.normal(size=(
            args.batch, cfg.n_image_tokens, cfg.d_frontend)).astype(
                np.float32)

    t0 = time.monotonic()
    res = eng.generate(batch)
    dt = time.monotonic() - t0
    print(f"arch={cfg.arch_id} gam={args.gam} "
          f"{args.batch}x{args.new_tokens} tokens in {dt:.2f}s")
    print("tokens:\n", res.tokens)
    names = (("decode_attention", "tess_project", "gam_score") if args.gam
             else ("decode_attention",))
    print(f"kernel launches: {_kernel_launches(*names)}")
    if args.gam:
        print(f"vocab rows scored/step: {res.n_scored_vocab:.0f} "
              f"of {cfg.vocab} (discard {res.discard_frac:.1%}, "
              f"speed-up x{1 / max(1 - res.discard_frac, 1e-9):.2f} on the "
              f"head matmul)")


if __name__ == "__main__":
    main()
