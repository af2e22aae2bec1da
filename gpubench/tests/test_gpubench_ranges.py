"""The readers of the program's stages on the profiler's timeline
(``ranges.py``): on hand-built profiles, and on small traced CPU runs of
every cell."""
import pytest

from gpubench.tests._common import BENCH, CELLS, RETRIEVAL_CELLS, small
from gpubench import bench
from gpubench.trace import Profile, _union

#: the readers of the program's ``repro_torch.<stage>`` ranges
STAGE_METRICS = ("assemble_ms", "fetch_ms", "query_idle_ms",
                 "launches_per_request")


def _profile(host, device, t0=0, t1=100_000_000):
    """A traced window of ``host`` and ``device`` ``(name, a, b)`` in ns."""
    prof = Profile.__new__(Profile)
    prof.t0, prof.t1 = t0, t1
    prof.host, prof.device = list(host), list(device)
    prof._busy = _union([[a, b] for _, a, b in prof.device])
    return prof


class _Run:
    def __init__(self, prof, queries=(2048, 2048)):
        self.profile = prof
        self.queries = list(queries)
        self.notes = {}


def _read(metric, run):
    return bench.reader(metric + ".online")(run, metric + ".online")


# two requests: 10–40 ms and 50–90 ms of a 100 ms window; the card
# runs 20–30 ms and 60–85 ms, so it idles 0–20, 30–60 and 85–100 ms, of
# which 10–20, 30–40, 50–60 and 85–90 ms (35 ms) fall inside the requests
HOST = [("repro_torch.query", 10_000_000, 40_000_000),
        ("repro_torch.map", 11_000_000, 12_000_000),
        ("cudaLaunchKernel", 11_500_000, 11_600_000),
        ("repro_torch.fetch", 20_000_000, 31_000_000),
        ("repro_torch.assemble", 31_000_000, 39_000_000),
        ("repro_torch.query", 50_000_000, 90_000_000),
        ("cuLaunchKernelEx", 55_000_000, 55_100_000),
        ("cudaLaunchKernelExC", 56_000_000, 56_100_000),
        ("repro_torch.fetch", 60_000_000, 86_000_000),
        ("repro_torch.assemble", 86_000_000, 89_000_000),
        ("cudaLaunchKernel", 45_000_000, 45_100_000),     # between requests
        ("cudaMemcpyAsync", 20_000_000, 30_000_000),      # no launch
        ("aten::add", 12_000_000, 13_000_000)]
DEVICE = [("tile_kernel<float, 4>", 20_000_000, 30_000_000),
          ("merge_kernel", 60_000_000, 80_000_000),
          ("Memcpy DtoH (Device -> Pageable)", 79_000_000, 85_000_000),
          ("sum_kernel", 20_500_000, 21_000_000)]


def test_stage_ms_is_host_time_in_the_ranges_over_the_requests():
    run = _Run(_profile(HOST, DEVICE))
    assert _read("fetch_ms", run) == pytest.approx((11 + 26) / 2)
    assert _read("assemble_ms", run) == pytest.approx((8 + 3) / 2)
    assert run.notes["stages"] == ("host ms a request: assemble 5.5000, "
                                   "fetch 18.5000, map 0.5000, "
                                   "query 35.0000")


def test_query_idle_ms_is_the_idle_time_inside_query_ranges():
    run = _Run(_profile(HOST, DEVICE))
    assert _read("query_idle_ms", run) == pytest.approx(35 / 2)
    # 0–20, 30–60 and 85–100 ms: 65 ms idle, 35 of them inside
    assert run.notes["idle in repro_torch.query"].startswith(
        "0.035000 s of the window's 0.065000 s device-idle (53.85%)")


def test_launches_per_request_counts_launch_calls_inside_query_ranges():
    run = _Run(_profile(HOST, DEVICE))
    assert _read("launches_per_request", run) == pytest.approx(3 / 2)
    assert run.notes["launches in repro_torch.query"] == (
        "3 launch calls inside, 4 in the window, 3 kernel activities in "
        "the window, 2 requests")


def test_overlapping_ranges_of_one_stage_count_once():
    host = HOST + [("repro_torch.fetch", 25_000_000, 35_000_000)]
    assert _read("fetch_ms", _Run(_profile(host, DEVICE))) == \
        pytest.approx((15 + 26) / 2)


@pytest.mark.parametrize("metric", STAGE_METRICS)
def test_a_reader_finds_nothing_without_its_ranges_or_profile(metric):
    """The parent's program opens no range: every reader returns ``None``,
    as it does without a profile; on the CPU the device ones do too."""
    bare = [h for h in HOST if not h[0].startswith("repro_torch.")]
    assert _read(metric, _Run(_profile(bare, DEVICE))) is None
    assert _read(metric, _Run(None)) is None
    assert _read(metric, _Run(_profile(HOST, DEVICE), queries=())) is None
    on_cpu = _read(metric, _Run(_profile(HOST, [])))
    assert (on_cpu is None) == (metric in ("query_idle_ms",
                                           "launches_per_request"))


@pytest.mark.parametrize("metric", STAGE_METRICS)
def test_each_stage_metric_is_declared_for_the_accepted_cells(metric):
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for suffix in ("batch", "online"):
        m = {x["name"]: x for x in BENCH["per_layer"]}[f"{metric}.{suffix}"]
        assert m["source"] == "program_span"
        assert m["better"] == "lower"
        assert set(m["workloads"]) <= set(e2e[m["moves"]].get("workloads",
                                                                CELLS))


@pytest.mark.parametrize("cell", RETRIEVAL_CELLS)
def test_a_small_traced_cpu_run_reports_the_host_stages(cell):
    out = bench.run(cell, 2**31 + 17, 0.3, True, device="cpu",
                    overrides=small(cell))
    assert out["correct"]
    suffix = "batch" if cell.endswith("batch4096") else "online"
    got = out["metrics"]
    for metric in ("assemble_ms", "fetch_ms"):
        assert got[f"{metric}.{suffix}"]["value"] > 0
        assert got[f"{metric}.{suffix}"]["unit"] == "ms"
    for metric in ("query_idle_ms", "launches_per_request"):
        assert f"{metric}.{suffix}" not in got
    assert "assemble" in out["notes"]["stages"]
