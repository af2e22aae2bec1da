"""Paths, the cells of ``BENCHMARK.json`` and small sizes shared by the
benchmark's CPU tests."""
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
HERE = Path(__file__).resolve().parent
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
#: every cell of the benchmark, as ``BENCHMARK.json`` lists them
CELLS = tuple(w["name"] for w in BENCH["workloads"])


def config_of(cell: str) -> dict:
    """The cell's configuration, as its file holds it."""
    work = {w["name"]: w for w in BENCH["workloads"]}[cell]
    conf = {c["name"]: c for c in BENCH["configs"]}[work["config"]]
    return json.loads((ROOT / conf["file"]).read_text())


def kind_of(cell: str) -> str:
    """The kind of system the cell's configuration names."""
    return config_of(cell).get("system", "retrieval")


#: the cells whose system is the retrieval kind's
RETRIEVAL_CELLS = tuple(c for c in CELLS if kind_of(c) == "retrieval")


def traffic_of(cell: str) -> dict:
    """The cell's traffic mix, as its file holds it."""
    work = {w["name"]: w for w in BENCH["workloads"]}[cell]
    path = ROOT / "gpubench" / "traffic" / f"{work['traffic']}.json"
    return json.loads(path.read_text())


def small(cell: str) -> dict:
    """Overrides that shrink ``cell`` for the CPU, from ``small/<kind>.json``
    (the widths as configured): its ``config`` whole, and of its
    ``traffic`` the keys the cell's mix has."""
    shrink = json.loads((HERE / "small" / f"{kind_of(cell)}.json")
                        .read_text())
    mix = traffic_of(cell)
    return {"config": shrink["config"],
            "traffic": {k: v for k, v in shrink["traffic"].items()
                        if k in mix}}
