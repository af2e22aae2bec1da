"""PyTorch/CUDA port of the GAM retrieval system.

Mirrors the subpackage layout of the JAX package ``repro`` (``core``,
``kernels``, ``retriever``, ``checkpoint``).  Plain tensor code is PyTorch;
the Pallas kernels of the query path are hand-written CUDA C++ for Hopper
(``kernels/csrc``), built with ``nvcc`` at first use.  Entry points run on
``cuda`` unless the caller passes ``device="cpu"``, where every kernel
wrapper takes its plain PyTorch version.
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
