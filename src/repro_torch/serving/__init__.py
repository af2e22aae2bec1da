"""Batched LM serving: the engine and the GAM-accelerated LM head."""
from repro_torch.serving.engine import Engine, GenerationResult, ServeConfig
from repro_torch.serving.gam_head import GamHead

__all__ = ["Engine", "GamHead", "GenerationResult", "ServeConfig"]
