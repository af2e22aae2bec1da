"""Matrix factorisation trainer (paper §6.2 substrate), in PyTorch.

Counterpart of ``repro.factorization.mf``: L2-regularised MF on observed
(user, item, rating) triples, trained with minibatch SGD + momentum.  It
produces the latent factors U, V the GAM mapping consumes; no biases,
centred ratings, as in the reference.

The gradient is the reference's ``jax.value_and_grad`` of the gathered sum
loss, written out: each rating gives its user row ``2 e v + 2 reg u`` and
its item row ``2 e u + 2 reg v`` (the L2 term once per occurrence of a row
in the batch), summed into full (n, k) gradients.  Momentum and the update
then move every row, so rows outside the batch keep moving by their
velocity.  The sums over a row's samples run in batch order
(:func:`scatter_rows`), so two runs with one seed give the same bits.

Draws: one ``numpy.random.default_rng(cfg.seed)`` draws U, then V, then one
permutation an epoch, the reference's numbers in the reference's order.
The ratings move to the device once; each epoch's permutation once; each
step's mse stays on the device until the epoch's are copied together.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.device import resolve_device

__all__ = ["MfConfig", "MfState", "mf_minibatch_step", "train_mf"]


@dataclasses.dataclass(frozen=True)
class MfConfig:
    k: int = 10
    lr: float = 0.005
    reg: float = 0.02
    momentum: float = 0.9
    epochs: int = 30
    batch: int = 8192
    seed: int = 0
    center: bool = True


class MfState(NamedTuple):
    """Final trainer state: the warm-start contract for incremental MF.

    ``params``/``vel`` are ``{"u": (n_users, k), "v": (n_items, k)}`` f32
    tensors (params and momentum velocity); ``offset`` is the rating mean
    subtracted before training (0.0 when ``center=False``)."""

    params: dict
    vel: dict
    offset: float


def scatter_rows(n: int, rows: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """(n, k) sums of the per-sample rows of ``g`` at ``rows``: a stable
    sort of the rows, then one segmented sum that adds each row's samples
    in batch order, one after another, on either device.  No atomics: two
    runs give the same bits, and so do the CPU and the card."""
    sr, order = torch.sort(rows, stable=True)
    bounds = torch.searchsorted(sr, torch.arange(n + 1, device=rows.device))
    return torch.segment_reduce(g[order], "sum", lengths=torch.diff(bounds),
                                unsafe=True)


def _grads(params: dict, rows, cols, vals, reg: float):
    u = params["u"][rows]
    v = params["v"][cols]
    err = torch.sum(u * v, dim=1) - vals
    mse = torch.mean(err * err)
    ct = (2.0 * err)[:, None]
    gu = ct * v + reg * (2.0 * u)
    gv = ct * u + reg * (2.0 * v)
    return ({"u": scatter_rows(params["u"].shape[0], rows, gu),
             "v": scatter_rows(params["v"].shape[0], cols, gv)}, mse)


def mf_minibatch_step(params: dict, vel: dict, rows, cols, vals,
                      cfg: MfConfig) -> tuple[dict, dict, torch.Tensor]:
    """One momentum-SGD step on a (rows, cols, vals) minibatch (tensors on
    the params' device).  Returns ``(params, vel, mse)``, mse a 0-d tensor;
    the inputs are updated in place and returned."""
    grads, mse = _grads(params, rows, cols, vals, cfg.reg)
    for key in ("u", "v"):
        vel[key].mul_(cfg.momentum).add_(grads[key])
        params[key].sub_(cfg.lr * vel[key])
    return params, vel, mse


def train_mf(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
             n_users: int, n_items: int, cfg: MfConfig = MfConfig(),
             return_state: bool = False,
             device: str | torch.device | None = None):
    """Returns (U, V, history) with history = list of per-epoch train MSE;
    with ``return_state=True``, (U, V, history, MfState): the same U/V
    bits, plus the final optimizer state for streaming warm starts.  U and
    V are numpy; the state's tensors stay on ``device`` (``None``: the
    card)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(cfg.seed)
    vals = np.asarray(vals, np.float32)
    offset = float(vals.mean()) if cfg.center else 0.0
    vals = vals - offset
    params = {
        "u": torch.as_tensor(
            rng.normal(scale=0.1, size=(n_users, cfg.k)).astype(np.float32),
            device=dev),
        "v": torch.as_tensor(
            rng.normal(scale=0.1, size=(n_items, cfg.k)).astype(np.float32),
            device=dev),
    }
    vel = {key: torch.zeros_like(p) for key, p in params.items()}
    rows_d = torch.as_tensor(np.asarray(rows, np.int64), device=dev)
    cols_d = torch.as_tensor(np.asarray(cols, np.int64), device=dev)
    vals_d = torch.as_tensor(vals, device=dev)
    n = len(vals)
    history = []
    for _ in range(cfg.epochs):
        order = torch.as_tensor(rng.permutation(n), device=dev)
        mses = []
        for s in range(0, n, cfg.batch):
            idx = order[s:s + cfg.batch]
            params, vel, mse = mf_minibatch_step(
                params, vel, rows_d[idx], cols_d[idx], vals_d[idx], cfg)
            mses.append(mse)
        # one copy an epoch; the mean over the f32 values is numpy's, as in
        # the reference's np.mean of float(mse) per step
        history.append(float(np.mean(
            torch.stack(mses).cpu().numpy().astype(np.float64))))
    u, v = params["u"].cpu().numpy(), params["v"].cpu().numpy()
    if return_state:
        return u, v, history, MfState(params=params, vel=vel, offset=offset)
    return u, v, history
