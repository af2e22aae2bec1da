"""Run one cell of the benchmark of ``repro_torch`` on this machine's card.

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout.  Prints the result as the last line of
standard output (one JSON object) and each number the comparison held,
beside its limit, as the last lines of standard error.  Exits non-zero,
printing no result, without a CUDA card, with fewer cards than the cell
asks for, or when JAX or the JAX package is loaded once the window has
closed.  The program's kernels build into ``build/repro_torch/<hash>/``
inside the checkout; other caches go under ``build/gpubench/``.

A configuration may state the deployment's process environment
(``runtime.env``, such as the C library's allocator settings).  Those
variables take effect only when a process starts, so the command sets them
and replaces itself (``exec``: no second process) before anything loads;
set-up is still counted from the first start.
"""
from __future__ import annotations

import os
import time

# CLOCK_MONOTONIC: one clock across the exec below
T_START = float(os.environ.pop("GPUBENCH_T_START", time.perf_counter()))

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _caches() -> None:
    """Every cache a library may keep, at fixed paths inside the checkout."""
    cache = ROOT / "build" / "gpubench"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(cache / sub)


def runtime_env(workload: str, root: Path = ROOT) -> dict[str, str]:
    """The process environment the cell's configuration states
    (``runtime.env``); empty for an unknown cell."""
    try:
        bench = json.loads((root / "BENCHMARK.json").read_text())
        work = {w["name"]: w for w in bench["workloads"]}[workload]
        conf = {c["name"]: c for c in bench["configs"]}[work["config"]]
        config = json.loads((root / conf["file"]).read_text())
    except (OSError, KeyError, ValueError):
        return {}
    return {str(k): str(v) for k, v in
            config.get("runtime", {}).get("env", {}).items()}


def _power_limit() -> str | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out[0] if out else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    env = runtime_env(args.workload)
    if any(os.environ.get(k) != v for k, v in env.items()):
        os.environ.update(env)
        os.environ["GPUBENCH_T_START"] = repr(T_START)
        sys.stdout.flush()
        sys.stderr.flush()
        rest = sys.argv[1:] if argv is None else list(argv)
        os.execv(sys.executable,
                 [sys.executable, str(Path(__file__).resolve()), *rest])
    _caches()
    sys.path.insert(0, str(ROOT))
    import torch
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    chips = {w["name"]: int(w["chips"]) for w in bench["workloads"]}
    if args.workload not in chips:
        print(f"gpubench: no workload {args.workload!r}", file=sys.stderr)
        return 2
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < chips[args.workload]):
        print(f"gpubench: {args.workload} needs {chips[args.workload]} "
              f"CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    from gpubench.bench import banned_modules, run
    result = run(args.workload, args.seed, args.seconds, bool(args.trace),
                 t_start=T_START, chips=chips[args.workload])
    found = banned_modules()
    if found:
        print(f"gpubench: the run loaded {', '.join(found)}: the benchmark "
              "measures repro_torch alone", file=sys.stderr)
        return 3
    result["device"]["power"] = _power_limit()
    checks = result.pop("checks")
    notes = result.pop("notes", {})
    result["checks"] = checks          # the compared numbers come last
    for name, note in notes.items():
        print(f"gpubench: {name}: {note}", file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
