"""Training primitives of the port (counterpart of ``repro.training``): the
optimizers.  ``evaluate`` comes with the LM-training slice."""
from repro_torch.training.optimizer import (AdamWConfig, AdamWState,
                                            adamw_init, adamw_update,
                                            cosine_schedule, global_norm,
                                            sgd_update)

__all__ = ["AdamWConfig", "AdamWState", "adamw_init", "adamw_update",
           "cosine_schedule", "global_norm", "sgd_update"]
