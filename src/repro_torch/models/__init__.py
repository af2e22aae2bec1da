"""The LM substrate of the port: the dense family (GQA attention + SwiGLU),
its layers, and weight conversion from the reference's parameter tree."""
from repro_torch.models.model import Model

__all__ = ["Model"]
