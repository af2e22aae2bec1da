"""Paths, the cells of ``BENCHMARK.json`` and small sizes shared by the
benchmark's CPU tests."""
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
#: every cell of the benchmark, as ``BENCHMARK.json`` lists them
CELLS = tuple(w["name"] for w in BENCH["workloads"])

#: each cell at a size a test run holds (the widths as configured)
SMALL = {"config": {"data": {"n_items": 3000, "n_users": 2000}},
         "traffic": {"request_size": 64, "sample": 256,
                     "warmup_requests": 1}}
#: set-up's mutations, shrunk, for a mix that has them
MUTATIONS = {"rounds": 2, "fresh": 64, "rewrite": 64, "rewrite_zipf": 1.1,
             "delete": 32}


def traffic_of(cell: str) -> dict:
    """The cell's traffic mix, as its file holds it."""
    work = {w["name"]: w for w in BENCH["workloads"]}[cell]
    path = ROOT / "gpubench" / "traffic" / f"{work['traffic']}.json"
    return json.loads(path.read_text())


def small(cell: str) -> dict:
    """Overrides that shrink ``cell`` for the CPU."""
    traffic = dict(SMALL["traffic"])
    if traffic_of(cell).get("setup_mutations"):
        traffic["setup_mutations"] = MUTATIONS
    return {"config": SMALL["config"], "traffic": traffic}
