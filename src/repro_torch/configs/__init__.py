"""Model shapes of the port: copies of ``repro.configs`` (the dataclasses,
the registry, the input shapes and the ten architecture files).  They are
shapes only; no weights are fetched."""
from repro_torch.configs.base import ModelConfig, ShapeConfig, reduced
from repro_torch.configs.registry import (ARCH_IDS, get_config,
                                          get_reduced_config)

__all__ = ["ARCH_IDS", "ModelConfig", "ShapeConfig", "get_config",
           "get_reduced_config", "reduced"]
