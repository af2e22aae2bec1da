"""Carry trainer state between the reference and the port, both ways.

The reference keeps its states as JAX arrays in dicts; converted to numpy
(``np.asarray`` on each), they become the port's tensors on a device here,
and the port's states become numpy dicts the reference adopts.

* :func:`mf_state_from_reference` / :func:`mf_state_to_reference`:
  ``train_mf(..., return_state=True)``'s params, momentum velocity and
  rating offset.
* :func:`streaming_from_reference` / :func:`streaming_to_reference`: a
  ``StreamingMF``'s factor tables, velocities, AdaGrad accumulators and
  counters, at the capacities they have.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.factorization.mf import MfState
from repro_torch.online.trainer import OnlineMFConfig, StreamingMF

__all__ = ["mf_state_from_reference", "mf_state_to_reference",
           "streaming_from_reference", "streaming_to_reference"]

# the counters a StreamingMF carries besides its tables
COUNTERS = ("n_users", "n_items", "n_events", "n_steps", "n_grows",
            "last_mse", "last_grad_norm", "offset")


def _tensors(tree: dict, device: torch.device) -> dict:
    return {key: torch.tensor(np.asarray(a, np.float32), device=device)
            for key, a in tree.items()}


def _arrays(tree: dict) -> dict:
    return {key: t.detach().cpu().numpy() for key, t in tree.items()}


def mf_state_from_reference(params: dict, vel: dict, offset: float, *,
                            device: str | torch.device | None = None
                            ) -> MfState:
    """The reference's ``MfState`` fields as numpy dicts -> the port's
    :class:`MfState` on ``device`` (``None``: the card)."""
    dev = resolve_device(device)
    return MfState(params=_tensors(params, dev), vel=_tensors(vel, dev),
                   offset=float(offset))


def mf_state_to_reference(state: MfState) -> tuple[dict, dict, float]:
    """The port's :class:`MfState` -> (params, vel, offset), numpy dicts."""
    return _arrays(state.params), _arrays(state.vel), float(state.offset)


def streaming_from_reference(params: dict, vel: dict, gsq: dict,
                             counters: dict, cfg: OnlineMFConfig, *,
                             device: str | torch.device | None = None
                             ) -> StreamingMF:
    """A reference ``StreamingMF``'s ``_params``/``_vel``/``_gsq`` (numpy
    dicts) and its :data:`COUNTERS` -> the port's trainer on ``device``."""
    t = StreamingMF(cfg, device=device)
    t._params = _tensors(params, t.device)
    t._vel = _tensors(vel, t.device)
    t._gsq = _tensors(gsq, t.device)
    for name in COUNTERS:
        setattr(t, name, counters[name])
    return t


def streaming_to_reference(t: StreamingMF) -> tuple[dict, dict, dict, dict]:
    """The port's trainer -> (params, vel, gsq, counters), numpy dicts."""
    return (_arrays(t._params), _arrays(t._vel), _arrays(t._gsq),
            {name: getattr(t, name) for name in COUNTERS})
