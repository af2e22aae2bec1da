#!/usr/bin/env python3
"""Where a dry-run step's per-device count goes, by aten op: the flops and
collective bytes by (op, the shapes of its first two inputs), and the
bytes accessed by op, each list its top entries.

    PYTHONPATH=src python3 tools/cost_breakdown.py [--arch tinyllama-1.1b]
        [--shape train_4k] [--multi-pod] [--top 12]

The step is placed and counted as ``python -m repro_torch.launch.dryrun``
counts it (meta tensors over the fake production mesh, no card), so the
breakdown shows which of the installed torch's DTensor strategies the
count holds: two torch versions give two counts.  Prints the torch
version first.  Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import collections
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args()

    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.launch.cost import CostCounter
    from repro_torch.launch.dryrun import build_lowered
    from repro_torch.launch.mesh import abstract_production_mesh

    flops, coll, nbytes = (collections.Counter() for _ in range(3))

    class Breakdown(CostCounter):
        """A counter that also files each op's share under its name."""

        def _count(self, func, op_args, kwargs, out, ins, outs):
            f0, b0 = sum(self.flops.values()), self.bytes_accessed
            c0 = sum(self.collectives.values())
            super()._count(func, op_args, kwargs, out, ins, outs)
            key = f"{func} {[tuple(t.shape) for t in ins[:2]]}"
            flops[key] += sum(self.flops.values()) - f0
            coll[key] += sum(self.collectives.values()) - c0
            nbytes[str(func)] += self.bytes_accessed - b0

    print(f"torch {torch.__version__}")
    t0 = time.monotonic()
    with abstract_production_mesh(multi_pod=args.multi_pod) as mesh:
        lowered = build_lowered(get_config(args.arch), SHAPES[args.shape],
                                mesh)
        counter = Breakdown()
        counter.arguments(*lowered.args)
        with counter:
            lowered.fn(*lowered.args)
    print(f"{args.arch} x {args.shape} on "
          f"{'2x16x16' if args.multi_pod else '16x16'}, counted in "
          f"{time.monotonic() - t0:.1f} s: flops/device {counter.flops}, "
          f"bytes/device {counter.bytes_accessed}, collectives/device "
          f"{counter.collectives}")
    for title, ctr in (("flops", flops), ("collective bytes", coll),
                       ("bytes accessed", nbytes)):
        print(f"{title} by op:")
        for key, v in ctr.most_common(args.top):
            print(f"  {v:.4g}  {key}")


if __name__ == "__main__":
    main()
