"""The LM substrate of the port: every family of the reference (dense, MoE,
MLA, SSM, the RG-LRU hybrid, encoder-decoder, VLM), its layers and mixers,
and weight conversion from the reference's parameter tree."""
from repro_torch.models.model import Model

__all__ = ["Model"]
