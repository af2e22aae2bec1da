"""The harness finds every cell, configuration, traffic mix, limit and
metric by name, ``BENCHMARK.json`` keeps to its contract's shape, and the
command refuses to run without a card."""
import json
import re
import subprocess
import sys

import pytest

from gpubench.tests._common import BENCH, CELLS, ROOT, traffic_of
from gpubench import bench
from gpubench.run import runtime_env

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
#: the longest window the benchmark's contract allows a run
RUN_SECONDS_MAX = 51


def test_benchmark_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["gpubench"]
    assert 1 <= BENCH["run_seconds"] <= RUN_SECONDS_MAX
    names = [x["name"] for key in ("configs", "workloads", "end_to_end",
                                   "per_layer") for x in BENCH[key]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    configs = {c["name"] for c in BENCH["configs"]}
    assert {w["config"] for w in BENCH["workloads"]} == configs
    assert all(w["chips"] in (1, 4) for w in BENCH["workloads"])
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_finds_its_files(cell):
    work, conf = bench.cell(BENCH, cell)
    config = json.loads((ROOT / conf["file"]).read_text())
    assert config["source"] == conf["source"]
    assert config["reduced"] == conf["reduced"]
    assert (bench.HERE / "traffic" / f"{work['traffic']}.json").exists()
    limits = json.loads((bench.HERE / "limits" / f"{cell}.json").read_text())
    assert set(limits) == set(bench.system_kind(config).NUMBERS)
    for traced in (False, True):
        metrics = bench.metrics_of(BENCH, cell, traced)
        assert metrics, (cell, traced)
        for m in metrics:
            assert callable(bench.reader(m["name"]))
    e2e = {m["name"] for m in bench.metrics_of(BENCH, cell, False)}
    assert "setup_s" in e2e and len(e2e) >= 2


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_runs_the_shape_its_mix_names(cell):
    """The window runs one closed-loop client; a mix asking for another
    shape is refused, never run as that one."""
    mix = traffic_of(cell)
    assert (mix.get("loop", "closed"), mix.get("clients", 1)) == ("closed", 1)
    for other in ({"loop": "open"}, {"clients": 4}):
        with pytest.raises(ValueError, match="closed-loop"):
            bench.set_up(cell, 1, device="cpu",
                         overrides={"traffic": other})


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_states_its_process_environment(cell):
    """The command applies the configuration's ``runtime.env``, found by
    the cell's name, and nothing for an unknown cell."""
    _, conf = bench.cell(BENCH, cell)
    config = json.loads((ROOT / conf["file"]).read_text())
    want = {k: str(v) for k, v in
            config.get("runtime", {}).get("env", {}).items()}
    assert runtime_env(cell) == want
    assert runtime_env("no-such-cell") == {}


def test_every_metric_is_reported_somewhere():
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert set(m.get("workloads", CELLS)) <= set(CELLS), m["name"]


def test_the_command_refuses_without_a_card():
    proc = subprocess.run(
        [sys.executable, str(ROOT / "gpubench" / "run.py"), "--workload",
         CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    if proc.returncode == 0:
        pytest.skip("this machine has a card")
    assert proc.stdout == ""
    assert "CUDA" in proc.stderr


class _Stop(Exception):
    pass


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("traced", (False, True))
def test_a_window_is_profiled_where_a_metric_reads_the_trace(
        cell, traced, monkeypatch):
    """A window runs under the profiler in every traced run, and in an
    untraced one exactly where an end-to-end metric of the cell reads the
    device trace."""
    from gpubench.tests._common import small
    seen = []

    def window(run, system, seconds, profiled, seed, min_requests=1):
        seen.append(profiled)
        raise _Stop

    monkeypatch.setattr(bench, "_window", window)
    with pytest.raises(_Stop):
        bench.run(cell, 3, 0.1, traced, device="cpu", overrides=small(cell))
    want = traced or any(m["source"] == "device_trace"
                         for m in bench.metrics_of(BENCH, cell, False))
    assert seen == [want]


def test_device_us_per_query_is_busy_time_over_queries():
    read = bench.reader("device_us_per_query")

    class Prof:
        device = [("k", 0, 1)]
        busy_s = 0.5

    class R:
        profile = Prof()
        queries = [1000, 1000]

    assert read(R(), "device_us_per_query") == pytest.approx(250.0)
    R.profile = None
    assert read(R(), "device_us_per_query") is None
    R.profile, Prof.device = Prof(), []
    assert read(R(), "device_us_per_query") is None


def test_kernel_us_per_query_leaves_out_copies_and_sets():
    from gpubench.trace import Profile
    read = bench.reader("kernel_us_per_query.online")
    prof = Profile.__new__(Profile)
    prof.device = [("tile_kernel<float, 4>", 0, 3_000_000),
                   ("Memcpy DtoH (Device -> Pageable)", 3_000_000, 9_000_000),
                   ("Memset (Device)", 9_000_000, 9_500_000),
                   ("merge_kernel", 9_500_000, 10_500_000)]

    class R:
        profile = prof
        queries = [2000, 2000]

    assert read(R(), "kernel_us_per_query.online") == pytest.approx(1.0)
    prof.device = prof.device[1:3]
    assert read(R(), "kernel_us_per_query.online") is None
    R.profile = None
    assert read(R(), "kernel_us_per_query.online") is None
