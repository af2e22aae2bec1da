"""Local multi-process ``torch.distributed`` spawn recipe (demo/CI).

Counterpart of ``repro.launch.procs``.  Three surfaces spawn cooperating
worker processes on one machine — the ``launch/serve.py --hosts N`` parent,
``tests/multihost/run_multiprocess_torch.py`` and ``chip_smoke.py``'s
multi-host phase — and they must agree on the fiddly parts: a free
coordinator port, the worker environment, joining the process group with a
finite timeout, and supervision that cannot leak children on a hang.  This
module is the single owner of that recipe.

The group runs the gloo backend: the multi-host tier gathers O(Q * kappa)
accumulators as CPU tensors, and NCCL refuses two ranks on one card.  A
worker that sees a card computes on ``cuda:{rank % device_count}``, so
ranks on a one-card machine share it.
"""
from __future__ import annotations

import datetime
import os
import socket
import subprocess
import time

__all__ = ["free_coordinator", "init_process_group", "run_workers",
           "worker_env"]

# variables of the JAX runtime, meaningless to the port's workers
_JAX_VARS = ("JAX_PLATFORMS", "XLA_FLAGS")


def free_coordinator(host: str = "127.0.0.1") -> str:
    """``host:port`` with a currently free TCP port for the process group's
    rendezvous.  (Best-effort: the port is released before the workers bind
    it — the standard local-spawn race, fine for demo/CI single-machine
    use.)"""
    with socket.socket() as s:
        s.bind((host, 0))
        return f"{host}:{s.getsockname()[1]}"


def worker_env(base: dict | None = None) -> dict:
    """Worker-process environment: the parent's, with the JAX variables
    dropped.  ``CUDA_VISIBLE_DEVICES`` is left as it is — a worker runs on
    the card unless its own arguments ask for the CPU."""
    env = dict(os.environ if base is None else base)
    for var in _JAX_VARS:
        env.pop(var, None)
    return env


def init_process_group(coordinator: str, world_size: int, rank: int, *,
                       timeout_s: float = 300.0,
                       backend: str = "gloo") -> None:
    """Join the process group at ``tcp://{coordinator}`` as ``rank`` of
    ``world_size`` (the counterpart of ``jax.distributed.initialize``).

    ``timeout_s`` bounds the rendezvous and every collective, so a hung or
    dead peer fails this process instead of waiting forever.  ``backend``:
    gloo by default; a device mesh of ranks sharing one card names gloo
    for both devices (``"cpu:gloo,cuda:gloo"``).  When a card is present,
    this process's default CUDA device becomes ``rank % device_count``."""
    import torch
    import torch.distributed as dist

    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator}", rank=int(rank),
        world_size=int(world_size),
        timeout=datetime.timedelta(seconds=float(timeout_s)))
    if torch.cuda.is_available():
        torch.cuda.set_device(int(rank) % torch.cuda.device_count())


def run_workers(commands: list[list[str]], *, timeout: float = 600.0,
                capture: bool = False) -> tuple[list[int], list[str]]:
    """Spawn one process per command, wait for all under one deadline.

    Returns ``(exit_codes, stdouts)`` (stdouts empty unless ``capture``).
    On deadline every straggler is killed and reported as exit code 124 —
    a hung collective never wedges the caller.
    """
    env = worker_env()
    procs = [subprocess.Popen(cmd, env=env,
                              stdout=subprocess.PIPE if capture else None,
                              text=capture)
             for cmd in commands]
    deadline = time.monotonic() + timeout
    codes, outs = [], []
    for p in procs:
        left = max(deadline - time.monotonic(), 0.0)
        try:
            out, _ = p.communicate(timeout=left)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
            codes.append(124)
            outs.append(out or "")
            continue
        codes.append(p.returncode)
        outs.append(out or "")
    return codes, outs
