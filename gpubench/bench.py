"""One run of one cell: set-up, the measured window, the comparison with the
reference, and the result.

Everything a cell needs is found by name: its entry in ``BENCHMARK.json``,
its configuration's file, ``traffic/<traffic>.json``, ``limits/<cell>.json``
and, for each metric, the reader ``metrics/<name>.py`` (or, where there is
none, ``metrics/<name before its first dot>.py``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import json
import resource
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch

from gpubench.gen import traffic as gen
from gpubench.reference.compare import NUMBERS, judge
from gpubench.reference.phi import parse_tree_dim, posting_lengths
from gpubench.reference.retrieval import Answer, Catalog, answer, live_catalog
from gpubench.system import System
from gpubench.trace import WINDOW, Profile

__all__ = ["BANNED", "Run", "banned_modules", "cell", "judge_run", "live",
           "reader", "run", "set_up"]

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
#: top-level modules no run may hold once its window has closed
BANNED = ("jax", "jaxlib", "flax", "repro")
#: rows of each answer the window keeps for the comparison to draw from
KEPT = 32


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(bench: dict, name: str) -> tuple[dict, dict]:
    """The workload ``name`` and its configuration's entry."""
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r}; known: {sorted(work)}")
    conf = {c["name"]: c for c in bench["configs"]}[work[name]["config"]]
    return work[name], conf


def metrics_of(bench: dict, name: str, traced: bool) -> list[dict]:
    """The cell's end-to-end metrics, or with ``traced`` its per-layer ones."""
    group = bench["per_layer" if traced else "end_to_end"]
    return [m for m in group if name in m.get("workloads", [name])]


def reader(name: str, here: Path = HERE):
    """The ``read(run, name)`` function of metric ``name``."""
    path = here / "metrics" / f"{name}.py"
    if not path.exists():
        path = here / "metrics" / f"{name.split('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(
        "gpubench_metric_" + path.stem.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def banned_modules() -> list[str]:
    """Loaded modules whose top-level name is one of :data:`BANNED`."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in BANNED})


def _merge(base: dict, over: dict | None) -> dict:
    out = dict(base)
    for key, val in (over or {}).items():
        out[key] = (_merge(out[key], val) if isinstance(val, dict)
                    and isinstance(out.get(key), dict) else val)
    return out


@dataclasses.dataclass
class Run:
    """What a metric's reader reads."""

    name: str
    config: dict
    traffic: dict
    data: gen.Traffic
    device: torch.device
    setup_s: float = 0.0
    peak_bytes: int = 0
    t0: float = 0.0                   # the window, host clock
    t1: float = 0.0
    reference_s: float = 0.0          # the reference's work inside set-up
    latencies_s: list = dataclasses.field(default_factory=list)
    queries: list = dataclasses.field(default_factory=list)
    n_scored: list = dataclasses.field(default_factory=list)  # a request's
    kept: list = dataclasses.field(default_factory=list)  # (i, rows, answer)
    failed: int = 0
    launches: int = 0                 # the fused kernel's, in the window
    n_live: int = 0                   # catalog rows served in the window
    spans: list = dataclasses.field(default_factory=list)
    profile: Profile | None = None
    notes: dict = dataclasses.field(default_factory=dict)   # readers' words

    @property
    def kind(self) -> str | None:
        return (torch.cuda.get_device_name(self.device)
                if self.device.type == "cuda" else None)

    def peaks(self) -> dict | None:
        """The data sheet's peaks of this run's card (``peaks.json``)."""
        table = json.loads((HERE / "peaks.json").read_text())
        return table.get(self.kind or "")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _kept_rows(keep_seed: int, i: int, b: int, m: int) -> np.ndarray:
    """The rows of request ``i`` whose answers the window keeps for the
    comparison: ``m`` of its ``b``, drawn from the run's seed."""
    rng = np.random.default_rng([keep_seed, i])
    return np.sort(rng.choice(b, min(m, b), replace=False))


def _host_counters() -> dict:
    """The process's CPU seconds, all threads, and its main thread's wait
    on the run queue where the kernel shows it."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    out = {"cpu_s": ru.ru_utime + ru.ru_stime}
    with contextlib.suppress(OSError, ValueError):
        _, wait_ns, _ = Path("/proc/self/schedstat").read_text().split()
        out["runq_s"] = int(wait_ns) / 1e9
    return out


def _host_note(before: dict, after: dict, wall: float) -> str:
    """The window's host seconds, as a note: a host that spins on the card
    reads CPU seconds near the wall's."""
    note = f"wall {wall:.3f} s, cpu {after['cpu_s'] - before['cpu_s']:.3f} s"
    if "runq_s" in before and "runq_s" in after:
        note += f", run-queue wait {after['runq_s'] - before['runq_s']:.3f} s"
    return note


def _window(run: Run, system, seconds: float, profiled: bool, seed: int,
            min_requests: int = 1) -> None:
    """Requests back to back from one client for ``seconds``, and at least
    ``min_requests`` of them, under ``torch.profiler`` where ``profiled``.
    Of each answer the window keeps the rows drawn for the comparison, so
    a run holds no more than those."""
    data, dev = run.data, run.device
    keep_seed = gen.seeds(seed, 5)[4]
    prof = None
    if profiled:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    n_spans, launches = len(system.spans()), system.launches()
    host0 = _host_counters()
    try:
        with (torch.profiler.record_function(WINDOW) if profiled
              else contextlib.nullcontext()):
            run.t0 = te = time.perf_counter()
            i = 0
            while te - run.t0 < seconds or i < min_requests:
                users = data.request(i)
                ts = time.perf_counter()
                try:
                    res = system.query(users)
                except Exception:        # counted as failed; the loop goes on
                    if not run.failed:
                        traceback.print_exc()
                    run.failed += 1
                    res = None
                te = time.perf_counter()
                run.latencies_s.append(te - ts)
                run.queries.append(len(users))
                rows = _kept_rows(keep_seed, i, len(users), KEPT)
                run.n_scored.append(None if res is None
                                    else int(np.sum(res.n_scored)))
                run.kept.append((i, rows, None if res is None else (
                    np.asarray(res.ids)[rows], np.asarray(res.scores)[rows],
                    np.asarray(res.n_scored)[rows])))
                del res
                i += 1
            _sync(dev)
            run.t1 = te
        run.notes["host"] = _host_note(host0, _host_counters(),
                                       run.t1 - run.t0)
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
    run.launches = system.launches() - launches
    run.spans = system.spans()[n_spans:]
    lat = 1e3 * np.asarray(run.latencies_s)
    half = max(len(lat) // 2, 1)
    run.notes["requests"] = (
        f"{len(lat)} requests, ms p5 {np.percentile(lat, 5):.3f} p50 "
        f"{np.percentile(lat, 50):.3f} p95 {np.percentile(lat, 95):.3f} "
        f"max {lat.max():.3f}; mean first half {lat[:half].mean():.3f}, "
        f"second half {lat[-half:].mean():.3f}")
    if prof is not None:
        run.profile = Profile(prof.profiler.kineto_results.events())


def _sample(run: Run, seed: int) -> tuple[np.ndarray, Answer]:
    """The kept answers, ``traffic["sample"]`` of them drawn from the seed
    -> (users, the served answer)."""
    kappa = int(run.config["spec"]["kappa"])
    users, ids, scores, n = [], [], [], []
    for i, rows, got in run.kept:
        users.append(run.data.request(i)[rows])
        if got is None:               # a failed request serves nothing
            ids.append(np.full((rows.size, kappa), -1, np.int64))
            scores.append(np.full((rows.size, kappa), -np.inf, np.float32))
            n.append(np.full(rows.size, -1, np.int64))
        else:
            ids.append(got[0])
            scores.append(got[1])
            n.append(got[2])
    users, ids = np.concatenate(users), np.concatenate(ids)
    rng = np.random.default_rng(gen.seeds(seed, 6)[5])
    pick = np.sort(rng.choice(len(users), min(run.data.sample, len(users)),
                              replace=False))
    return users[pick], Answer(ids[pick], np.concatenate(scores)[pick],
                               np.concatenate(n)[pick])


def live(data: gen.Traffic, threshold: float, base: Catalog | None = None,
         precision: str = "f32", device="cpu") -> Catalog:
    """The live catalog after set-up's mutations, with its phi maps."""
    if not data.mutations and base is not None:
        return base
    ids, fac = (live_catalog(data.ids, data.items, data.mutations)
                if data.mutations else (data.ids, data.items))
    return Catalog.of(ids, fac, threshold, precision, device)


def set_up(name: str, seed: int, *, root: Path = ROOT, device: str = "cuda",
           overrides: dict | None = None, traced: bool = False
           ) -> tuple[Run, System, Catalog, dict]:
    """Data, the system built and mutated, every request shape warmed up
    -> (run, system, the reference's base catalog, limits)."""
    bench = load_benchmark(root)
    work, conf = cell(bench, name)
    over = overrides or {}
    config = _merge(json.loads((root / conf["file"]).read_text()),
                    over.get("config"))
    traffic = _merge(json.loads((HERE / "traffic" /
                                 f"{work['traffic']}.json").read_text()),
                     over.get("traffic"))
    limits = json.loads((HERE / "limits" / f"{name}.json").read_text())
    dev = torch.device(device)
    stages, t = {}, time.perf_counter()

    def stage(what: str) -> None:
        nonlocal t
        _sync(dev)
        now = time.perf_counter()
        stages[what] = now - t
        t = now

    data = gen.make(config["data"], traffic, seed)
    stage("data")
    thr = float(config["gam"]["threshold"])
    base = Catalog.of(data.ids, data.items, thr, device=dev)
    # the bucket holds the longest posting list: no list spills
    bucket = int(posting_lengths(base.tau, base.mask,
                                 parse_tree_dim(base.tau.shape[1])).max())
    stage("bucket")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    system = System(root, config, data.ids, data.items, bucket=bucket,
                    device=device, traced=traced)
    stage("build")
    for op in data.mutations:
        system.mutate(op)
    stage("mutations")
    for j in range(data.warmup_requests):
        system.query(data.request(-1 - j))
    stage("warm-up")
    run = Run(name, config, traffic, data, dev,
              reference_s=stages["bucket"])
    run.notes["setup"] = ", ".join(f"{k} {v:.3f} s" for k, v in stages.items())
    return run, system, base, limits


def judge_run(run: Run, base: Catalog, seed: int) -> dict:
    """The comparison's numbers for the answers ``run`` served, once the
    window has closed and the program's state is freed."""
    cfg, thr = run.config, float(run.config["gam"]["threshold"])
    cat = live(run.data, thr, base, device=run.device)
    run.n_live = len(cat.ids)
    users, served = _sample(run, seed)
    mo = int(cfg["spec"]["min_overlap"])
    ref = answer(cat, users, threshold=thr, min_overlap=mo,
                 kappa=int(cfg["spec"]["kappa"]), device=run.device)
    return judge(served, ref, cat, users, threshold=thr, min_overlap=mo,
                 device=run.device)


def run(name: str, seed: int, seconds: float, traced: bool, *,
        root: Path = ROOT, device: str = "cuda",
        overrides: dict | None = None, t_start: float | None = None,
        chips: int = 1) -> dict:
    """One run of cell ``name`` -> the result line's object."""
    t_start = time.perf_counter() if t_start is None else t_start
    run, system, base, limits = set_up(name, seed, root=root, device=device,
                                       overrides=overrides, traced=traced)
    # the reference's sizing of the bucket is the benchmark's, not set-up's
    run.setup_s = time.perf_counter() - t_start - run.reference_s
    run.notes["setup"] += (f"; {run.setup_s:.3f} s in all but the "
                           "reference's bucket")
    wanted = metrics_of(load_benchmark(root), name, traced)
    # a device-trace metric of --trace 0 has the window profiled too
    profiled = traced or any(m["source"] == "device_trace" for m in wanted)
    _window(run, system, seconds, profiled, seed)
    dev = run.device
    if dev.type == "cuda":
        run.peak_bytes = int(torch.cuda.max_memory_allocated(dev))
    system.close()
    del system
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    numbers = judge_run(run, base, seed)
    checks = {n: {"value": numbers[n], "limit": float(limits[n])}
              for n in NUMBERS}
    correct = (run.failed == 0 and len(run.kept) > 0
               and all(c["value"] <= c["limit"] for c in checks.values()))

    metrics = {}
    for m in wanted:
        value = reader(m["name"])(run, m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    device_out = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                  "kind": run.kind, "count": int(chips),
                  "memory_peak_bytes": run.peak_bytes}
    out = {"correct": bool(correct), "attempted": len(run.kept),
           "failed": run.failed, "metrics": metrics, "device": device_out}
    if traced and run.profile is not None and run.profile.device:
        device_out["busy_s"] = run.profile.busy_s
        device_out["window_s"] = run.profile.window_s
        out["breakdown"] = {"device_ops": run.profile.top_ops(),
                            "idle_gaps": run.profile.idle_gaps()}
    out["notes"] = run.notes
    out["checks"] = checks
    return out
