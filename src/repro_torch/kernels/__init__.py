"""Hand-written CUDA kernels of the port (``csrc/``), each beside its plain
PyTorch version; ``ops`` dispatches on the tensor's device.  The entry
points below are ``ops``' (the same four the reference's ``kernels``
exports); importing them builds nothing: a kernel is compiled at its first
launch on the card."""
from repro_torch.kernels.ops import (decode_attention, gam_retrieve,
                                     gam_score, tess_project)

__all__ = ["decode_attention", "gam_retrieve", "gam_score", "tess_project"]
