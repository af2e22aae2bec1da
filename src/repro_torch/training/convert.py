"""Carry an AdamW state between the reference's ``AdamWState`` and the port's.

The moments are f32 under any model dtype and the step count is int32, in
both packages, so unlike ``models.convert.params_from_reference`` (which
casts each weight to its config's dtype) these keep every leaf's dtype.  A
round trip is exact.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.training.optimizer import AdamWState, tree_map

__all__ = ["opt_state_from_reference", "opt_state_to_reference"]


def opt_state_from_reference(state, device=None) -> AdamWState:
    """A reference ``AdamWState(step, mu, nu)`` (arrays of any kind numpy
    reads) -> the port's, on ``device`` (default the card): ``step`` a ()
    int32 tensor, ``mu`` and ``nu`` trees of f32 tensors."""
    dev = resolve_device(device)

    def f32(x):
        return torch.from_numpy(np.array(x, np.float32)).to(dev)

    return AdamWState(
        step=torch.tensor(int(np.asarray(state.step)), dtype=torch.int32,
                          device=dev),
        mu=tree_map(f32, state.mu), nu=tree_map(f32, state.nu))


def opt_state_to_reference(state: AdamWState) -> AdamWState:
    """The port's state -> the same NamedTuple of numpy arrays (``step``
    a () int32 array, the moments f32), ready for the reference's
    ``AdamWState(*...)``."""
    def host(t):
        return t.detach().cpu().numpy()

    return AdamWState(step=np.asarray(host(state.step), np.int32),
                      mu=tree_map(host, state.mu), nu=tree_map(host, state.nu))
