"""The system under test: ``repro_torch``'s retriever API, and the spans and
counters the program keeps.  The one module of the benchmark that imports
the program.

A configuration's ``spec`` holds :class:`RetrieverSpec` fields by name and
its ``gam`` the mapping's; ``bucket`` is passed in, as the harness sizes it
from the reference's own phi.
"""
from __future__ import annotations

import importlib
import sys
from pathlib import Path

__all__ = ["System"]


def _program(root: Path) -> None:
    src = str(root / "src")
    if src not in sys.path:
        sys.path.insert(0, src)


class System:
    """One retriever of the program, opened from a configuration."""

    def __init__(self, root: Path, config: dict, ids, items, *, bucket: int,
                 device: str, traced: bool):
        _program(root)
        from repro_torch.core.mapping import GamConfig
        from repro_torch.obs.tracing import Tracer
        from repro_torch.retriever import RetrieverSpec, open_retriever
        self._kernels = importlib.import_module(
            "repro_torch.kernels.gam_retrieve")
        spec = dict(config["spec"], bucket=int(bucket))
        spec = RetrieverSpec(cfg=GamConfig(**config["gam"]), **spec)
        kw = {}
        self.tracer = None
        if traced and spec.backend.startswith("sharded"):
            # every request sampled; the harness reads the finished roots
            self.tracer = kw["tracer"] = Tracer(sample_rate=1.0,
                                                max_traces=1 << 22)
        self.retriever = open_retriever(spec, items=items, ids=ids,
                                        device=device, **kw)

    def mutate(self, op: tuple) -> None:
        if op[0] == "upsert":
            self.retriever.upsert(op[1], op[2])
        elif op[0] == "delete":
            self.retriever.delete(op[1])
        else:
            raise ValueError(f"unknown mutation {op[0]!r}")

    def query(self, users):
        return self.retriever.query(users)

    def launches(self) -> int:
        """Launches of the fused retrieval kernel so far (the program's
        counter)."""
        return int(self._kernels.gam_retrieve.launches)

    def spans(self) -> list:
        """Finished root spans of the program's tracer (none untraced)."""
        return [] if self.tracer is None else list(self.tracer.finished)

    def close(self) -> None:
        self.retriever = None
