"""The control: the reference put in the program's place, one precision
step below what the configurations state (phi in bfloat16, the products in
TF32).  The comparison has to find it not correct."""
from __future__ import annotations

import torch

from gpubench.reference.retrieval import Answer, Catalog, answer

__all__ = ["Control"]


class Control:
    """Answers requests as the program would, from ``cat`` (built with
    ``Catalog.of(..., precision="low")``)."""

    def __init__(self, cat: Catalog, config: dict, device):
        self.cat, self.device = cat, torch.device(device)
        self.threshold = float(config["gam"]["threshold"])
        self.min_overlap = int(config["spec"]["min_overlap"])
        self.kappa = int(config["spec"]["kappa"])

    def query(self, users) -> Answer:
        return answer(self.cat, users, threshold=self.threshold,
                      min_overlap=self.min_overlap, kappa=self.kappa,
                      device=self.device, precision="low")

    def launches(self) -> int:
        return 0

    def spans(self) -> list:
        return []

    def close(self) -> None:
        self.cat = None
