"""Matrix factorisation of the port (counterpart of
``repro.factorization``): the §6.2 trainer and its warm-start state."""
from repro_torch.factorization.mf import (MfConfig, MfState,
                                          mf_minibatch_step, train_mf)

__all__ = ["MfConfig", "MfState", "mf_minibatch_step", "train_mf"]
