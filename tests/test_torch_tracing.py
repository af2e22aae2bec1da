"""The port's request stages on the profiler's timeline, on the CPU.

Every ``trace`` / ``span`` / ``trace_or_span`` of ``repro_torch.obs``'s
tracers also opens a host range ``repro_torch.<stage>`` while a
``torch.profiler`` records: a kineto ``cpu_op``, never a user annotation
(which kineto would mirror onto the device's timeline as busy time).
``gam`` / ``gam-device`` answer under ``query`` -> ``map``, ``retrieve``,
``fetch``, ``assemble``; ``sharded`` keeps its tree and adds ``fetch`` and
``assemble``.  Observation never changes an answer.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

import repro_torch.obs.tracing as tracing  # noqa: E402
from repro_torch.core.mapping import GamConfig  # noqa: E402
from repro_torch.obs import NOOP_SPAN, NOOP_TRACER, Tracer  # noqa: E402
from repro_torch.retriever import RetrieverSpec, open_retriever  # noqa: E402

CFG = GamConfig(k=16, scheme="parse_tree", threshold=0.2)
BACKENDS = ("gam-device", "gam", "sharded")
#: each backend's stage tree of one query (``sharded`` with a live delta)
TREES = {
    "gam-device": ("query", (("map", ()), ("retrieve", ()), ("fetch", ()),
                             ("assemble", ()))),
    "gam": ("query", (("map", ()), ("retrieve", ()), ("fetch", ()),
                      ("assemble", ()))),
    "sharded": ("query", (("map", ()),
                          ("base", (("gam_retrieve", ()), ("fetch", ()))),
                          ("assemble", ()),
                          ("delta", (("fetch", ()),)),
                          ("merge", ()),
                          ("assemble", ()))),
}


def _factors(n: int, seed: int) -> np.ndarray:
    z = np.random.default_rng(seed).normal(size=(n, CFG.k)).astype(np.float32)
    return z / np.linalg.norm(z, axis=1, keepdims=True)


def _open(backend: str, traced: bool):
    """A retriever over 400 items; ``sharded`` with 3 shards and a delta."""
    kw = {"n_shards": 3} if backend == "sharded" else {}
    opts = (("trace_sample", 1.0),) if traced else ()
    spec = RetrieverSpec(cfg=CFG, backend=backend, min_overlap=2, bucket=128,
                         options=opts, **kw)
    r = open_retriever(spec, items=_factors(400, 1), device="cpu")
    if backend == "sharded":
        r.upsert(np.arange(1000, 1016), _factors(16, 2))
        r.delete(np.arange(0, 400, 37))
    return r


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name().startswith(tracing.RANGE_PREFIX)]
    return out, events


def _range_tree(events) -> list:
    """The ranges nested by containment -> [(stage, (children...)), ...]."""
    spans = sorted(((e.start_ns(), e.start_ns() + e.duration_ns(),
                     e.name()[len(tracing.RANGE_PREFIX):]) for e in events),
                   key=lambda s: (s[0], -s[1]))
    roots, stack = [], []
    for a, b, name in spans:
        node = (name, [])
        while stack and stack[-1][0] < b:
            stack.pop()
        (stack[-1][1][1] if stack else roots).append(node)
        stack.append((b, node))

    def freeze(node):
        return node[0], tuple(freeze(c) for c in node[1])
    return [freeze(n) for n in roots]


def _span_tree(span) -> tuple:
    return span.name, tuple(_span_tree(c) for c in span.children)


def _same_answer(a, b) -> None:
    np.testing.assert_array_equal(a.ids, b.ids)
    np.testing.assert_array_equal(a.scores, b.scores)
    np.testing.assert_array_equal(a.n_scored, b.n_scored)
    np.testing.assert_array_equal(a.discarded_frac, b.discarded_frac)
    assert a.explain == b.explain


# ------------------------------------------------------------ the tracers


@pytest.mark.parametrize("entry", ("trace", "span", "trace_or_span"))
@pytest.mark.parametrize("tracer", ("noop", "sampled", "unsampled"))
def test_every_entry_point_opens_a_host_range_under_the_profiler(
        entry, tracer):
    """Sampled or not, and for the no-op tracer too: one ``cpu_op`` named
    ``repro_torch.<stage>``, never a user annotation."""
    t = {"noop": NOOP_TRACER, "sampled": Tracer(sample_rate=1.0),
         "unsampled": Tracer(sample_rate=0.0)}[tracer]

    def body():
        with getattr(t, entry)("stage", a=1) as sp:
            torch.ones(4).sum()
            return sp
    sp, events = _profiled(body)
    assert [e.name() for e in events] == ["repro_torch.stage"]
    assert not events[0].is_user_annotation()
    assert str(events[0].device_type()).endswith("CPU")
    sampled = tracer == "sampled" and entry != "span"
    assert (sp is NOOP_SPAN) != sampled


@pytest.mark.parametrize("entry", ("trace", "span", "trace_or_span"))
@pytest.mark.parametrize("tracer", ("noop", "sampled", "unsampled"))
def test_no_range_is_opened_without_a_profiler(entry, tracer, monkeypatch):
    t = {"noop": NOOP_TRACER, "sampled": Tracer(sample_rate=1.0),
         "unsampled": Tracer(sample_rate=0.0)}[tracer]
    opened = []
    monkeypatch.setattr(tracing, "_RecordFunctionFast",
                        lambda name: opened.append(name))
    with getattr(t, entry)("stage"):
        pass
    assert opened == []


def test_a_failing_stage_closes_its_range_and_its_span():
    t = Tracer(sample_rate=1.0)

    def body():
        with pytest.raises(ValueError):
            with t.trace("query"):
                with t.span("fetch"):
                    raise ValueError("boom")
    _, events = _profiled(body)
    assert _range_tree(events) == [("query", (("fetch", ()),))]
    assert [c.name for c in t.finished[-1].children] == ["fetch"]
    assert t.finished[-1].children[0].t1 is not None


# ------------------------------------------------------------ the backends


@pytest.mark.parametrize("traced", (False, True))
@pytest.mark.parametrize("backend", BACKENDS)
def test_a_query_yields_its_stages_nested_as_the_tracer_nests_them(
        backend, traced):
    r = _open(backend, traced)
    users = _factors(9, 3)
    _, events = _profiled(lambda: r.query(users))
    assert all(not e.is_user_annotation() for e in events)
    assert all(str(e.device_type()).endswith("CPU") for e in events)
    assert _range_tree(events) == [TREES[backend]]
    if traced:
        assert _span_tree(r.tracer.finished[-1]) == TREES[backend]


def test_the_multihost_tree_gains_fetch_and_assemble_on_both_clocks():
    spec = RetrieverSpec(cfg=CFG, backend="sharded-multihost", n_shards=4,
                         n_hosts=2, replication=2, min_overlap=2,
                         bucket=128, options=(("trace_sample", 1.0),))
    r = open_retriever(spec, items=_factors(400, 1), device="cpu")
    r.upsert(np.arange(1000, 1008), _factors(8, 2))
    _, events = _profiled(lambda: r.query(_factors(7, 3)))
    tree = _span_tree(r.tracer.finished[-1])
    assert _range_tree(events) == [tree]
    names = [c[0] for c in tree[1]]
    assert names[0] == "map" and names[-4:] == ["assemble", "delta",
                                                "merge", "assemble"]
    assert names[-5] == "collective_merge"
    assert set(names[1:-5]) == {"host_topk"}
    for host_topk in tree[1][1:-5]:
        for slice_topk in host_topk[1]:
            assert [c[0] for c in slice_topk[1]] == ["gam_retrieve", "fetch"]
    assert tree[1][-3] == ("delta", (("fetch", ()),))


@pytest.mark.parametrize("backend", BACKENDS)
def test_no_range_is_opened_by_a_query_without_a_profiler(backend,
                                                          monkeypatch):
    r = _open(backend, True)
    opened = []
    monkeypatch.setattr(tracing, "_RecordFunctionFast",
                        lambda name: opened.append(name))
    r.query(_factors(5, 4))
    assert opened == []
    assert r.tracer.finished        # the span tree is recorded all the same


@pytest.mark.parametrize("explain", (False, True))
@pytest.mark.parametrize("exact", (False, True))
@pytest.mark.parametrize("backend", BACKENDS)
def test_answers_are_bit_identical_with_tracing_on_and_off(backend, exact,
                                                           explain):
    users = _factors(11, 5)
    plain = _open(backend, False).query(users, exact=exact, explain=explain)
    traced = _open(backend, True)
    got, events = _profiled(lambda: traced.query(users, exact=exact,
                                                 explain=explain))
    assert events and traced.tracer.finished
    _same_answer(plain, got)


@pytest.mark.parametrize("backend", ("gam-device", "gam"))
def test_gam_index_retriever_exports_its_stage_tree(backend, tmp_path):
    r = _open(backend, True)
    assert isinstance(r.tracer, Tracer)
    r.query(_factors(6, 6))
    r.query(_factors(2, 7), kappa=3)
    path = tmp_path / "traces.jsonl"
    assert r.tracer.export_jsonl(str(path)) == 2
    lines = [json.loads(x) for x in path.read_text().splitlines()]
    for line, (q, kappa) in zip(lines, ((6, 10), (2, 3))):
        assert line["name"] == "query"
        assert line["attrs"] == {"q": q, "kappa": kappa}
        assert [c["name"] for c in line["children"]] == [
            "map", "retrieve", "fetch", "assemble"]
        assert all(c["duration_s"] >= 0 for c in line["children"])
    assert [x["trace_id"] for x in lines] == [0, 1]


def test_gam_index_retriever_takes_an_injected_tracer_and_sampling():
    t = Tracer(sample_rate=1.0)
    spec = RetrieverSpec(cfg=CFG, backend="gam-device", min_overlap=2,
                         bucket=128)
    r = open_retriever(spec, items=_factors(50, 8), device="cpu", tracer=t)
    assert r.tracer is t
    r.query(_factors(3, 9))
    assert len(t.finished) == 1
    assert _open("gam-device", False).tracer is NOOP_TRACER
    spec = RetrieverSpec(cfg=CFG, backend="gam-device", min_overlap=2,
                         bucket=128, options=(("trace_sample", 0.5),
                                              ("trace_seed", 3)))
    half = open_retriever(spec, items=_factors(50, 8), device="cpu")
    for _ in range(40):
        half.query(_factors(2, 10))
    assert half.tracer.sample_rate == 0.5
    assert half.tracer.n_started == 40
    assert 0 < half.tracer.n_sampled < 40


def test_an_empty_catalog_answers_under_the_query_root():
    spec = RetrieverSpec(cfg=CFG, backend="gam-device",
                         options=(("trace_sample", 1.0),))
    r = open_retriever(spec, device="cpu")
    _, events = _profiled(lambda: r.query(_factors(2, 11)))
    assert _range_tree(events) == [("query", ())]
    assert _span_tree(r.tracer.finished[-1]) == ("query", ())
