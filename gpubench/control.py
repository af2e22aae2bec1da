"""Readings that the comparison's limits are set from, on the card.

    python3 gpubench/control.py --workload <cell> --seeds 1 2 ... \
        [--control-seeds 1 2 3] [--seconds 2]

For each seed: set-up as a run makes it, a short window of the program at
the cell's own load, and the comparison's numbers; for each control seed
also the control (``reference/control.py``) in the program's place over
requests enough to fill the sample, and its numbers.  One JSON line a
reading on standard output.  Benchmark runs do not run this.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    from gpubench.bench import KEPT, Run, _window, judge_run, live, set_up
    from gpubench.reference.control import Control
    for seed in args.seeds:
        run, system, base, _ = set_up(args.workload, seed)
        _window(run, system, args.seconds, False, seed)
        system.close()
        del system
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        numbers = judge_run(run, base, seed)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "side": "program", "requests": len(run.kept),
                          "reference_s": time.perf_counter() - t0,
                          **numbers}), flush=True)
        if seed not in args.control_seeds:
            continue
        thr = float(run.config["gam"]["threshold"])
        ctl = Control(live(run.data, thr, precision="low", device=run.device),
                      run.config, run.device)
        crun = Run(run.name, run.config, run.traffic, run.data, run.device)
        need = -(-run.data.sample // min(KEPT, run.data.request_size))
        _window(crun, ctl, 0.0, False, seed, min_requests=need)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "side": "control", "requests": len(crun.kept),
                          **judge_run(crun, base, seed)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
