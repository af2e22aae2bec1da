"""Training primitives of the port (counterpart of ``repro.training``): the
optimizers, the evaluation harness, and the carriers of an AdamW state
between the two packages (``training.convert``)."""
from repro_torch.training.evaluate import EvalResult, eval_batches
from repro_torch.training.optimizer import (AdamWConfig, AdamWState,
                                            adamw_init, adamw_update,
                                            cosine_schedule, global_norm,
                                            sgd_update)

__all__ = ["AdamWConfig", "AdamWState", "EvalResult", "adamw_init",
           "adamw_update", "cosine_schedule", "eval_batches", "global_norm",
           "sgd_update"]
