"""Device and precision policy of the port.

Entry points take an explicit ``device``; ``None`` means the card.  There is
no silent fallback: asking for ``cuda`` on a machine without one raises, so a
run that believes it measured the card never ran on the CPU.  Every f32
scoring path is IEEE f32, so TF32 stays off for matmuls and convolutions.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` -> ``cuda``; raises if CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on the GPU by default and no CUDA device is "
            "available; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
