"""Online learning tier of the port (counterpart of ``repro.online``):
streaming matrix factorisation and geometry-aware publishing into the live
retriever, the layer that closes the paper's train -> map -> serve loop.

- :class:`EventBatch` — timestamp-ordered implicit-feedback events.
- :class:`StreamingMF` — ``partial_fit`` incremental WMF on the trainer's
  device, with per-row adaptive steps, pow2 capacity growth and
  ``train_mf`` warm start.
- :class:`PushPolicy` — angular-drift + staleness gated ``upsert``
  publisher.
- :class:`DriftSimulator` — seeded concept-drift workload.
"""
from repro_torch.online.drift import DriftSimulator
from repro_torch.online.events import EventBatch
from repro_torch.online.push import PushPolicy
from repro_torch.online.trainer import OnlineMFConfig, StreamingMF

__all__ = ["DriftSimulator", "EventBatch", "OnlineMFConfig", "PushPolicy",
           "StreamingMF"]
