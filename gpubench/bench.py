"""One run of one cell: set-up, the measured window, the comparison with the
reference, and the result.

Everything a cell needs is found by name: its entry in ``BENCHMARK.json``,
its configuration's file, the kind of system that file names
(``systems/<system>.py``; ``retrieval`` where it names none),
``traffic/<traffic>.json``, ``limits/<cell>.json`` and, for each metric,
the reader ``metrics/<name>.py`` (or, where there is none,
``metrics/<name before its first dot>.py``).

The window is one closed-loop client (it sends each request once the last
is answered) for every kind: a mix's ``loop`` and ``clients``, where it
gives them, may be only ``"closed"`` and 1, and any other value is
refused, not run as closed.

``set_up`` loads the kind's module once a run and keeps it as
``Run.system_kind``.  It gives the harness, by these names:

* ``NUMBERS``: the comparison's numbers; ``limits/<cell>.json`` holds a
  limit for each, and no other.
* ``draw(config, traffic, seed)``: the data and traffic drawn from the
  seed, an object with ``request(i)`` (request ``i`` of the window;
  ``i < 0``: warm-up), ``warmup_requests`` and ``mutations`` (set-up's,
  maybe none).
* ``prepare(config, data, device)``: the benchmark's own set-up work (the
  reference's), kept out of ``setup_s``; its result is handed to
  ``open_system``, ``judge`` and ``control``.
* ``open_system(root, config, data, prepared, device=, traced=)``: the
  system on the program's normal path, with ``query(request)``,
  ``mutate(op)``, ``launches()``, ``spans()`` and ``close()``.
* ``recorder(run, seed)``: ``record(i, request, answer)`` (``answer`` is
  ``None`` where the request failed) -> (the queries the request
  answered, what the window keeps of it for the comparison); it may keep
  on ``run`` what the kind's own readers read.
* ``judge(run, prepared, seed)``: the comparison's numbers, once the
  window has closed and the program's state is freed.
* ``control(run, prepared)``: (the control in the program's place, the
  requests it answers to fill the comparison), for ``control.py``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import json
import re
import resource
import sys
import time
import traceback
from pathlib import Path
from types import ModuleType

import numpy as np
import torch

from gpubench.trace import WINDOW, Profile

__all__ = ["BANNED", "Run", "banned_modules", "cell", "judge_run", "reader",
           "run", "set_up", "system_kind"]

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
#: top-level modules no run may hold once its window has closed
BANNED = ("jax", "jaxlib", "flax", "repro")
#: the kind of a configuration that names none
DEFAULT_KIND = "retrieval"
_KIND_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_-]{0,63}$")


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


def _load(path: Path, name: str) -> ModuleType:
    """The module at ``path``, loaded by path under ``name``.  It is entered
    in ``sys.modules``, where ``dataclasses`` looks up a class's module."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def reader(name: str, here: Path = HERE):
    """The ``read(run, name)`` function of metric ``name``."""
    path = here / "metrics" / f"{name}.py"
    if not path.exists():
        path = here / "metrics" / f"{name.split('.')[0]}.py"
    return _load(path, "gpubench_metric_" + path.stem.replace(".", "_")).read


def system_kind(config: dict, here: Path = HERE) -> ModuleType:
    """The module of the kind of system ``config`` names
    (``systems/<system>.py``)."""
    kind = config.get("system", DEFAULT_KIND)
    path = here / "systems" / f"{kind}.py"
    if not (isinstance(kind, str) and _KIND_NAME.match(kind)
            and path.is_file()):
        raise FileNotFoundError(f"the configuration names system {kind!r}: "
                                f"no module {path}")
    return _load(path, "gpubench_system_" + kind.replace("-", "_"))


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
    """What a metric's reader reads.  The fields are every kind's; a kind's
    module may keep more on the run for its own readers."""

    name: str
    config: dict
    traffic: dict
    data: object                      # the kind's draw
    system_kind: ModuleType           # the kind's module (systems/<kind>.py)
    device: torch.device
    setup_s: float = 0.0
    peak_bytes: int = 0
    t0: float = 0.0                   # the window, host clock
    t1: float = 0.0
    reference_s: float = 0.0          # the benchmark's work inside set-up
    latencies_s: list = dataclasses.field(default_factory=list)
    queries: list = dataclasses.field(default_factory=list)   # a request's
    kept: list = dataclasses.field(default_factory=list)  # the kind's record
    failed: int = 0
    launches: int = 0                 # the program's counter, in the window
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
    Of each answer the window keeps what the kind's record draws for the
    comparison, so a run holds no more than that."""
    data, dev = run.data, run.device
    record = run.system_kind.recorder(run, seed)
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
                request = data.request(i)
                ts = time.perf_counter()
                try:
                    res = system.query(request)
                except Exception:        # counted as failed; the loop goes on
                    if not run.failed:
                        traceback.print_exc()
                    run.failed += 1
                    res = None
                te = time.perf_counter()
                run.latencies_s.append(te - ts)
                n, kept = record(i, request, res)
                run.queries.append(n)
                run.kept.append(kept)
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


def _limits(name: str, kind: ModuleType) -> dict:
    """``limits/<cell>.json``: a limit for each of the kind's numbers."""
    path = HERE / "limits" / f"{name}.json"
    limits = json.loads(path.read_text())
    if set(limits) != set(kind.NUMBERS):
        raise ValueError(f"{path} holds {sorted(limits)}; the kind's numbers "
                         f"are {sorted(kind.NUMBERS)}")
    return limits


def set_up(name: str, seed: int, *, root: Path = ROOT, device: str = "cuda",
           overrides: dict | None = None, traced: bool = False
           ) -> tuple[Run, object, object, dict]:
    """Data, the system built and mutated, every request shape warmed up
    -> (run, system, the kind's prepared reference, limits)."""
    bench = load_benchmark(root)
    work, conf = cell(bench, name)
    over = overrides or {}
    config = _merge(json.loads((root / conf["file"]).read_text()),
                    over.get("config"))
    traffic = _merge(json.loads((HERE / "traffic" /
                                 f"{work['traffic']}.json").read_text()),
                     over.get("traffic"))
    shape = (traffic.get("loop", "closed"), int(traffic.get("clients", 1)))
    if shape != ("closed", 1):
        raise ValueError(f"the window runs one closed-loop client, not "
                         f"loop {shape[0]!r} with {shape[1]} clients")
    kind = system_kind(config)
    limits = _limits(name, kind)
    dev = torch.device(device)
    stages, t = {}, time.perf_counter()

    def stage(what: str) -> None:
        nonlocal t
        _sync(dev)
        now = time.perf_counter()
        stages[what] = now - t
        t = now

    data = kind.draw(config, traffic, seed)
    stage("data")
    prepared = kind.prepare(config, data, dev)
    stage("reference")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    system = kind.open_system(root, config, data, prepared, device=device,
                              traced=traced)
    stage("build")
    for op in data.mutations:
        system.mutate(op)
    stage("mutations")
    for j in range(data.warmup_requests):
        system.query(data.request(-1 - j))
    stage("warm-up")
    run = Run(name, config, traffic, data, kind, dev,
              reference_s=stages["reference"])
    run.notes["setup"] = ", ".join(f"{k} {v:.3f} s" for k, v in stages.items())
    return run, system, prepared, limits


def judge_run(run: Run, prepared, seed: int) -> dict:
    """The comparison's numbers for what ``run`` served, once the window
    has closed and the program's state is freed."""
    return run.system_kind.judge(run, prepared, seed)


def run(name: str, seed: int, seconds: float, traced: bool, *,
        root: Path = ROOT, device: str = "cuda",
        overrides: dict | None = None, t_start: float | None = None,
        chips: int = 1) -> dict:
    """One run of cell ``name`` -> the result line's object."""
    t_start = time.perf_counter() if t_start is None else t_start
    run, system, prepared, limits = set_up(name, seed, root=root,
                                           device=device, overrides=overrides,
                                           traced=traced)
    # the reference's work in set-up is the benchmark's, not the program's
    run.setup_s = time.perf_counter() - t_start - run.reference_s
    run.notes["setup"] += (f"; {run.setup_s:.3f} s in all but the "
                           "reference's set-up")
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
    numbers = judge_run(run, prepared, seed)
    checks = {n: {"value": numbers[n], "limit": float(limits[n])}
              for n in run.system_kind.NUMBERS}
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
