"""StreamingMF: incremental matrix factorisation over implicit-feedback
event streams, in PyTorch.

Counterpart of ``repro.online.trainer``.  ``partial_fit(events)`` consumes
timestamp-ordered :class:`EventBatch`\\ es and advances the factor tables
on the trainer's device: WMF-style weighted regression (confidence
``c = 1 + alpha * |value|`` per event, an L2 pull masked per event), a
momentum velocity, and per-row adaptive steps ``lr / (1 + sqrt(gsq))``
from an AdaGrad accumulator ``gsq`` of squared gradient mass a row.  The
update goes through ``training.optimizer.sgd_update`` and clipping through
``global_norm``, as in the reference.  Under ``update_users=False`` the
user *step* is zeroed, while the user velocity and accumulator still move.

The gradient is the reference's ``jax.value_and_grad`` written out and
summed into full tables with :func:`~repro_torch.factorization.mf.scatter_rows`
(duplicates in batch order on either device).  The reference pads each
chunk of events to a power of two with zero-confidence rows for JAX's jit
cache; the port runs eager and does not pad (such rows add exactly zero to
every sum of the update; a test holds a padded step to an unpadded one).

Capacities are powers of two >= 64.  Cold-start rows are drawn per 64-row
block from ``numpy.random.default_rng((seed, ord(axis), block))``, so every
growth path gives the same rows, and the reference's.

Warm start: ``StreamingMF.from_state(mf_state)`` adopts ``train_mf(...,
return_state=True)``'s params, momentum velocity and rating offset, from
the port's :class:`MfState` or the reference's converted to numpy.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.factorization.mf import MfState, scatter_rows
from repro_torch.online.events import EventBatch
from repro_torch.training.optimizer import global_norm, sgd_update

__all__ = ["OnlineMFConfig", "StreamingMF"]

_CAP_MIN = 64                          # smallest factor-table capacity


def _pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def _host(x) -> np.ndarray:
    """A tensor on any device, or an array, as f32 numpy."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.array(x, np.float32)


@dataclasses.dataclass(frozen=True)
class OnlineMFConfig:
    k: int = 16
    lr: float = 0.1
    reg: float = 1e-4
    momentum: float = 0.9
    alpha: float = 1.0                 # confidence = 1 + alpha * |value|
    batch: int = 1024                  # max events per step
    clip_norm: float = 0.0             # 0 = no gradient clipping
    seed: int = 0
    init_scale: float = 0.1            # cold-start row init (train_mf's)
    update_users: bool = True          # False freezes user factors


def online_step(params: dict, vel: dict, gsq: dict, rows, cols, prefs, confs,
                cfg: OnlineMFConfig):
    """One weighted minibatch step on tensors of one device.  Rows with
    ``confs == 0`` contribute no error gradient and no L2 pull.  Returns new
    ``(params, vel, gsq, mse, grad_norm)``, the last two 0-d tensors."""
    u = params["u"][rows]
    v = params["v"][cols]
    d = torch.sum(u * v, dim=1) - prefs
    live = (confs > 0).to(torch.float32)
    err2 = confs * (d * d)
    mse = torch.sum(err2) / torch.clamp(torch.sum(confs), min=1e-9)
    ct = (confs * (2.0 * d))[:, None]
    c = cfg.reg * live[:, None]
    grads = {"u": scatter_rows(params["u"].shape[0], rows,
                               ct * v + 2.0 * (c * u)),
             "v": scatter_rows(params["v"].shape[0], cols,
                               ct * u + 2.0 * (c * v))}
    gnorm = global_norm(grads)
    if cfg.clip_norm > 0:
        scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
        grads = {key: g * scale for key, g in grads.items()}
    gsq = {key: gsq[key] + torch.sum(g * g, dim=1)
           for key, g in grads.items()}
    vel = {key: cfg.momentum * vel[key] + g for key, g in grads.items()}
    step = {key: (cfg.lr / (1.0 + torch.sqrt(gsq[key])))[:, None] * vel[key]
            for key in ("u", "v")}
    if not cfg.update_users:
        step["u"] = torch.zeros_like(step["u"])
    return sgd_update(1.0, step, params), vel, gsq, mse, gnorm


class StreamingMF:
    """Incremental WMF trainer with growable pow2-capacity factor tables on
    ``device`` (``None``: the card)."""

    def __init__(self, cfg: OnlineMFConfig = OnlineMFConfig(), *,
                 n_users: int = 0, n_items: int = 0, offset: float = 0.0,
                 device: str | torch.device | None = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.offset = float(offset)
        self.n_users = 0               # 1 + max user id seen
        self.n_items = 0
        self.n_events = 0
        self.n_steps = 0
        self.n_grows = 0
        self.last_mse = None
        self.last_grad_norm = None
        self._params = {"u": self._init_rows("u", 0, _CAP_MIN),
                        "v": self._init_rows("v", 0, _CAP_MIN)}
        self._vel = {key: torch.zeros_like(p)
                     for key, p in self._params.items()}
        self._gsq = {key: torch.zeros(_CAP_MIN, dtype=torch.float32,
                                      device=self.device)
                     for key in ("u", "v")}
        if n_users or n_items:
            self._ensure_capacity(n_users, n_items)
            self.n_users, self.n_items = int(n_users), int(n_items)

    # ------------------------------------------------------------ warm start

    @classmethod
    def from_state(cls, state: MfState,
                   cfg: OnlineMFConfig = OnlineMFConfig(), *,
                   device: str | torch.device | None = None
                   ) -> "StreamingMF":
        """Adopt ``train_mf(..., return_state=True)``'s final state: params,
        momentum velocity and rating offset continue seamlessly."""
        t = cls(cfg, offset=state.offset, device=device)
        t.warm_start(u=state.params["u"], v=state.params["v"],
                     vel_u=state.vel["u"], vel_v=state.vel["v"])
        return t

    def warm_start(self, *, u=None, v=None, vel_u=None, vel_v=None,
                   offset: float | None = None) -> None:
        """Overwrite the leading factor (and optionally velocity) rows."""
        if offset is not None:
            self.offset = float(offset)
        for axis, fac, vel in (("u", u, vel_u), ("v", v, vel_v)):
            if fac is None:
                continue
            fac = _host(fac)
            if fac.shape[1] != self.cfg.k:
                raise ValueError(f"expected k={self.cfg.k}, got {fac.shape}")
            n = fac.shape[0]
            self._ensure_capacity(n if axis == "u" else 0,
                                  n if axis == "v" else 0)
            self._params[axis][:n] = torch.as_tensor(fac, device=self.device)
            if vel is not None:
                self._vel[axis][:n] = torch.as_tensor(_host(vel),
                                                      device=self.device)
            if axis == "u":
                self.n_users = max(self.n_users, n)
            else:
                self.n_items = max(self.n_items, n)

    # -------------------------------------------------------------- capacity

    def _init_rows(self, axis: str, lo: int, hi: int) -> torch.Tensor:
        """Deterministic cold-start rows [lo, hi), seeded per _CAP_MIN-row
        block (lo and hi land on block boundaries)."""
        blocks = []
        for b in range(lo, hi, _CAP_MIN):
            rng = np.random.default_rng((self.cfg.seed, ord(axis), b))
            blocks.append(rng.normal(
                scale=self.cfg.init_scale,
                size=(min(_CAP_MIN, hi - b), self.cfg.k)).astype(np.float32))
        return torch.as_tensor(np.concatenate(blocks), device=self.device)

    def _ensure_capacity(self, n_users: int, n_items: int) -> None:
        for axis, need in (("u", n_users), ("v", n_items)):
            cap = self._params[axis].shape[0]
            if need <= cap:
                continue
            new_cap = max(_pow2(need), _CAP_MIN)
            fresh = self._init_rows(axis, cap, new_cap)
            self._params[axis] = torch.cat([self._params[axis], fresh])
            self._vel[axis] = torch.cat([self._vel[axis],
                                         torch.zeros_like(fresh)])
            self._gsq[axis] = torch.cat([
                self._gsq[axis],
                torch.zeros(new_cap - cap, dtype=torch.float32,
                            device=self.device)])
            self.n_grows += 1

    @property
    def capacity(self) -> tuple[int, int]:
        return (int(self._params["u"].shape[0]),
                int(self._params["v"].shape[0]))

    # ------------------------------------------------------------- training

    def partial_fit(self, events: EventBatch) -> dict:
        """Consume one timestamp-ordered event batch; returns fit stats
        including ``touched_items`` (the ids whose factors moved — what a
        push policy should offer to the retriever)."""
        if not isinstance(events, EventBatch):
            raise TypeError(f"expected EventBatch, got {type(events)}")
        if len(events) == 0:
            return {"n_events": 0, "n_steps": 0, "mse": None,
                    "grad_norm": None,
                    "touched_users": np.empty(0, np.int64),
                    "touched_items": np.empty(0, np.int64)}
        cfg, dev = self.cfg, self.device
        self._ensure_capacity(int(events.users.max()) + 1,
                              int(events.items.max()) + 1)
        self.n_users = max(self.n_users, int(events.users.max()) + 1)
        self.n_items = max(self.n_items, int(events.items.max()) + 1)

        prefs_all = torch.as_tensor(
            events.values.astype(np.float32) - self.offset, device=dev)
        confs_all = torch.as_tensor(
            1.0 + cfg.alpha * np.abs(events.values).astype(np.float32),
            device=dev)
        users = torch.as_tensor(events.users, device=dev)
        items = torch.as_tensor(events.items, device=dev)
        params, vel, gsq = self._params, self._vel, self._gsq
        n_steps = 0
        for s in range(0, len(events), cfg.batch):
            sl = slice(s, s + cfg.batch)
            params, vel, gsq, mse, gnorm = online_step(
                params, vel, gsq, users[sl], items[sl], prefs_all[sl],
                confs_all[sl], cfg)
            n_steps += 1
        self._params, self._vel, self._gsq = params, vel, gsq
        self.n_events += len(events)
        self.n_steps += n_steps
        self.last_mse = float(mse)
        self.last_grad_norm = float(gnorm)
        return {"n_events": len(events), "n_steps": n_steps,
                "mse": self.last_mse, "grad_norm": self.last_grad_norm,
                "touched_users": np.unique(events.users),
                "touched_items": np.unique(events.items)}

    # -------------------------------------------------------------- factors

    def _rows(self, axis: str, n: int, ids) -> np.ndarray:
        table = self._params[axis]
        if ids is None:
            return table[:n].cpu().numpy()
        ids = np.asarray(ids, np.int64)
        if ids.size and (ids.min() < 0 or ids.max() >= n):
            raise IndexError(f"{axis} id out of range [0, {n})")
        return table[torch.as_tensor(ids, device=self.device)].cpu().numpy()

    def user_factors(self, ids=None) -> np.ndarray:
        return self._rows("u", self.n_users, ids)

    def item_factors(self, ids=None) -> np.ndarray:
        return self._rows("v", self.n_items, ids)

    def stats(self) -> dict:
        cap_u, cap_v = self.capacity
        return {"n_users": self.n_users, "n_items": self.n_items,
                "cap_users": cap_u, "cap_items": cap_v,
                "n_events": self.n_events, "n_steps": self.n_steps,
                "n_grows": self.n_grows, "mse": self.last_mse,
                "grad_norm": self.last_grad_norm, "offset": self.offset}
