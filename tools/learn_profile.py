#!/usr/bin/env python3
"""Where the learning loop's steps spend their time on one GPU: a
``train_mf`` minibatch step at MovieLens-20M's shape and a ``StreamingMF``
round at 1M items, each timed and traced.

    python3 tools/learn_profile.py [--steps 200]

1. ``mf_minibatch_step`` at ``gam_mf.MF``'s settings (k 10, batch 8,192)
   on tables of 138,493 users and 26,744 items, batches drawn from
   ``movielens_like_ratings`` at that shape and an eighth of its density
   (the same popularity, 2.1 M ratings): ``--steps`` steps timed back to
   back (host clock around them, a synchronize at the end), then 50 steps
   under ``torch.profiler``.
2. ``StreamingMF.partial_fit`` at phase 8c's settings (1,048,576 items,
   8,192 events a round in chunks of 1,024): 5 rounds timed, then one
   round under the profiler.
Each trace prints the device's busy share of the window (the sum of the
kernels' device time over the window's wall time; the kernels do not
overlap on one stream), the device and host time by operator (top 8), and
the number of host synchronizations (``cudaStreamSynchronize``,
``cudaDeviceSynchronize``) and device-to-host copies made in the window.
Exits non-zero without a CUDA device.  Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def trace(torch, fn, n: int, label: str) -> None:
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e6
    events = prof.key_averages()
    dev = sum(getattr(e, "self_device_time_total", 0.0) for e in events
              if e.device_type.name == "CUDA")
    syncs = sum(e.count for e in events
                if "Synchronize" in e.key and e.key.startswith("cuda"))
    d2h = sum(e.count for e in events if "DtoH" in e.key)
    print(f"{label}: {n} calls traced in {wall / 1e3:.2f} ms wall; device "
          f"busy {dev / 1e3:.2f} ms, share {dev / wall:.3f}; host "
          f"synchronizations {syncs}, device-to-host copies {d2h}")
    if dev == 0:
        print(f"{label}: the profiler saw no device time (not measured)")
    for key, sort in (("device", "self_device_time_total"),
                      ("host", "self_cpu_time_total")):
        top = sorted(events, key=lambda e: -getattr(e, sort, 0.0))[:8]
        print(f"{label}: top by {key} time: " + "; ".join(
            f"{e.key[:48]} {getattr(e, sort, 0.0) / n:.1f} us x "
            f"{e.count / n:.2f}" for e in top))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("learn_profile: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import gam_mf
    from repro_torch.data import movielens_like_ratings
    from repro_torch.factorization.mf import mf_minibatch_step
    from repro_torch.online import DriftSimulator, OnlineMFConfig, StreamingMF

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    args = ap.parse_args()
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())

    # ---- 1. the offline step at MovieLens-20M's shape
    n_u, n_i, cfg = 138_493, 26_744, gam_mf.MF
    rows, cols, vals = movielens_like_ratings(seed=0, n_users=n_u,
                                              n_items=n_i, density=0.0054 / 8)
    rng = np.random.default_rng(0)
    params = {"u": torch.as_tensor(rng.normal(scale=0.1, size=(n_u, cfg.k))
                                   .astype(np.float32), device=dev),
              "v": torch.as_tensor(rng.normal(scale=0.1, size=(n_i, cfg.k))
                                   .astype(np.float32), device=dev)}
    vel = {k: torch.zeros_like(p) for k, p in params.items()}
    rows_d = torch.as_tensor(rows, device=dev)
    cols_d = torch.as_tensor(cols, device=dev)
    vals_d = torch.as_tensor(vals - vals.mean(), device=dev)
    order = torch.as_tensor(rng.permutation(len(vals)), device=dev)
    at = [0]

    def step():
        s = at[0] % (len(vals) - cfg.batch)
        at[0] += cfg.batch
        idx = order[s:s + cfg.batch]
        mf_minibatch_step(params, vel, rows_d[idx], cols_d[idx],
                          vals_d[idx], cfg)

    for _ in range(20):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        step()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / args.steps
    print(f"mf step at {n_u} x {n_i}, batch {cfg.batch}: {ms:.4f} ms a step "
          f"({cfg.batch / ms * 1e3:.0f} ratings/s), {args.steps} steps")
    trace(torch, step, 50, "mf step")

    # ---- 2. a streaming round at 1M items
    sim = DriftSimulator(n_users=64, n_items=1 << 20, k=10, seed=17,
                         drift=0.2, hot_frac=0.5, events_per_round=8192)
    t = StreamingMF(OnlineMFConfig(k=10, lr=0.5, momentum=0.6, reg=1e-4,
                                   batch=1024, seed=3, update_users=False),
                    device=dev)
    t.warm_start(u=sim.users, v=sim.items_at_start)
    batches = [sim.step() for _ in range(7)]
    t.partial_fit(batches[0])
    t0 = time.perf_counter()
    for ev in batches[1:6]:
        t.partial_fit(ev)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / 5
    print(f"partial_fit at {1 << 20} items, 8192 events in chunks of 1024: "
          f"{ms:.3f} ms a round")
    trace(torch, lambda: t.partial_fit(batches[6]), 1, "partial_fit round")
    return 0


if __name__ == "__main__":
    sys.exit(main())
