"""Core GAM library of the port: tessellation, permutation, the map phi,
the dense-bucket index and the dense oracle (counterpart of ``repro.core``)."""
from repro_torch.core.mapping import GamConfig, densify, pattern_overlap, sparse_map
from repro_torch.core.retrieval import masked_topk, recovery_accuracy
from repro_torch.core.tessellation import (dary_pattern, ternary_pattern,
                                           tess_vector, tess_vector_d)

__all__ = ["GamConfig", "dary_pattern", "densify", "masked_topk",
           "pattern_overlap", "recovery_accuracy", "sparse_map",
           "ternary_pattern", "tess_vector", "tess_vector_d"]
