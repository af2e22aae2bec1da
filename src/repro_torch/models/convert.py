"""Carry model weights between the reference's parameter tree and the port's.

The reference keeps a nested dict of arrays, ``blocks`` stacked (L, ...) by
``vmap`` and every weight ``(in, out)`` applied as ``x @ w``; the port keeps
the same tree of tensors, so the conversion only changes containers, dtype
and device.  ``params_to_reference`` gives numpy arrays (bf16 weights as
float32, which holds every bf16 value exactly); ``params_from_reference``
takes arrays of any float dtype numpy can cast to float32 (bf16 included)
and casts each to the reference's dtype for that leaf: f32 for the leaves
the reference keeps in f32 (``layers.F32_LEAVES``: the MoE router, the
SSM's A / D / dt bias, the RG-LRU's gate biases and Lambda), the config's
dtype for the rest.  A round trip is exact.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.layers import leaf_dtype

__all__ = ["params_from_reference", "params_to_reference"]


def params_from_reference(tree, cfg: ModelConfig, device=None):
    """Reference tree (arrays) -> the port's tree of tensors on ``device``
    (default the card), each float leaf in the reference's dtype under
    ``cfg``."""
    dev = resolve_device(device)

    def leaf(name, x):
        a = np.asarray(x)
        if a.dtype.kind in "iub":
            return torch.from_numpy(np.array(a)).to(dev)
        return torch.from_numpy(np.array(a, np.float32)).to(
            dev, leaf_dtype(name, cfg))

    def walk(name, node):
        if isinstance(node, dict):
            return {k: walk(k, v) for k, v in node.items()}
        return leaf(name, node)

    return walk("", tree)


def params_to_reference(params) -> dict:
    """The port's tree -> a tree of numpy arrays (floats as float32)."""
    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        t = node.detach().cpu()
        return (t.float() if t.is_floating_point() else t).numpy()

    return walk(params)
