"""The port's sharded streaming retrieval machinery (the ``sharded``
backend's parts).

Counterpart of ``repro.service``.  The facade that ties the parts together
is the ``sharded`` backend (``repro_torch.retriever.sharded``); open it
with::

    from repro_torch.retriever import RetrieverSpec, open_retriever
    r = open_retriever(RetrieverSpec(cfg=cfg, backend="sharded",
                                     n_shards=4, min_overlap=2),
                       items=factors, ids=item_ids)       # on the card
    r = open_retriever(spec, items=factors, device="cpu")  # plain versions

Components: ``ShardedGamIndex`` (the main segment, one fused-kernel launch
per bn-group), ``DeltaSegment`` (streamed mutations, one launch),
``CompactionPlanner`` (background compaction in bounded slices),
``Partition`` / ``Repartitioner`` / ``MapCache`` (skew-aware layouts),
``Microbatcher`` (size/deadline coalescing with QoS admission control),
``ServiceMetrics``, the QoS ladder, the fault injector and the result
cache.  ``metrics``, ``qos``, ``faults``, ``result_cache``, ``microbatch``
and ``collective`` are copies of the reference's jax-free modules, and so is
the load generator (``LoadGenerator`` / ``LoadProfile``, seeded Zipf
traffic).  ``GamService`` remains as the reference's deprecation shim over
the ``sharded`` backend.
"""
from repro_torch.service.collective import HostPlacement, NoLiveReplica
from repro_torch.service.compaction import CompactionPlanner
from repro_torch.service.delta import DeltaSegment
from repro_torch.service.faults import FaultInjected, FaultInjector, FaultSpec
from repro_torch.service.loadgen import LoadGenerator, LoadProfile, zipf_weights
from repro_torch.service.metrics import ServiceMetrics
from repro_torch.service.microbatch import Microbatcher, QueryResult
from repro_torch.service.qos import (DEGRADE_RUNGS, HealthTracker, QosPolicy,
                                     RequestShed, ResultEvicted)
from repro_torch.service.repartition import MapCache, Partition, Repartitioner
from repro_torch.service.result_cache import CachedResult, ResultCache
from repro_torch.service.service import GamService, ServiceConfig
from repro_torch.service.sharded_index import ShardedGamIndex, ShardTopK

__all__ = ["CachedResult", "CompactionPlanner", "DEGRADE_RUNGS",
           "DeltaSegment", "FaultInjected", "FaultInjector", "FaultSpec",
           "GamService", "HealthTracker", "HostPlacement", "LoadGenerator",
           "LoadProfile", "MapCache", "Microbatcher", "NoLiveReplica",
           "Partition", "QosPolicy", "QueryResult", "Repartitioner",
           "RequestShed", "ResultCache", "ResultEvicted", "ServiceConfig",
           "ServiceMetrics", "ShardTopK", "ShardedGamIndex", "zipf_weights"]
