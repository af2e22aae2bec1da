"""GAM-accelerated LM head: a thin adapter over a ``gam-device`` retriever.

Counterpart of ``repro.serving.gam_head``.  The LM head's ``hidden . E_v``
over every vocabulary row v is the paper's inner-product retrieval problem
with N = vocab and k = d_model.  ``GamHead.build`` opens the port's
``gam-device`` retriever over the unit-normalised unembedding rows (phi maps
them with the ``tess_project`` kernel at k = d_model), and per step:

  1. maps the hidden state with phi,
  2. pulls the candidate vocab ids from the posting table
     (``candidate_masks``: >= min_overlap pattern intersections),
  3. scores ONLY the candidates exactly, against the raw rows, with the
     ``gam_score`` kernel and returns the top-kappa under (score desc, id
     asc), as ``lax.top_k`` orders it.

``exact=True`` scores every row with a plain matmul (accuracy comparisons).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.mapping import GamConfig
from repro_torch.core.retrieval import topk_desc
from repro_torch.kernels import ops
from repro_torch.retriever import RetrieverSpec, open_retriever
from repro_torch.retriever.gam import GamIndexRetriever

__all__ = ["GamHead"]


@dataclasses.dataclass
class GamHead:
    retriever: GamIndexRetriever  # gam-device backend over normalised rows
    raw_embed: torch.Tensor       # (V, d) f32 raw rows for exact logits

    @property
    def cfg(self) -> GamConfig:
        return self.retriever.spec.cfg

    @property
    def index(self):
        """The backend's device posting table (kept for introspection)."""
        return self.retriever.device_index

    @property
    def embed(self) -> torch.Tensor:
        """Row-normalised embedding copy the index was built over."""
        return self.retriever._items_dev

    @staticmethod
    def build(embed, *, threshold: float = 1.5, min_overlap: int = 2,
              device=None) -> "GamHead":
        """``embed``: (V, d) output-embedding matrix (lm_head.T or tied).

        ``threshold`` is RMS-relative: a coordinate takes part in the
        sparsity pattern iff |z_j| >= threshold / sqrt(d) on the unit sphere.
        The rows are normalised on the host with numpy, as the reference
        does, so both packages index the same unit rows."""
        if isinstance(embed, torch.Tensor):
            embed = embed.detach().float().cpu().numpy()
        # C order: numpy's norm sums a row in another order when it is
        # strided (lm_head.T), which moves the unit rows by an ulp
        rows = np.ascontiguousarray(embed, np.float32)
        v, d = rows.shape
        cfg = GamConfig(k=d, scheme="parse_tree", threshold=threshold / d ** 0.5)
        norm = rows / (np.linalg.norm(rows, axis=1, keepdims=True) + 1e-9)
        spec = RetrieverSpec(cfg=cfg, backend="gam-device",
                             min_overlap=min_overlap, bucket=512)
        retriever = open_retriever(spec, items=norm, device=device)
        return GamHead(retriever=retriever,
                       raw_embed=torch.as_tensor(rows,
                                                 device=retriever.device))

    def candidates(self, hidden: torch.Tensor) -> torch.Tensor:
        """hidden: (B, d) -> (B, V) bool candidate masks on the device."""
        h = hidden.float()
        h = h / (torch.sqrt((h * h).sum(-1, keepdim=True)) + 1e-9)
        return self.retriever.candidate_masks(h)

    def topk(self, hidden: torch.Tensor, kappa: int, *, exact: bool = False):
        """hidden: (B, d) -> (values (B, kappa) f32, ids (B, kappa) int64,
        mask (B, V) or None).  Exact scores on the candidate set only."""
        h = hidden.float()
        if exact:
            vals, ids = topk_desc(h @ self.raw_embed.T, kappa)
            return vals, ids, None
        mask = self.candidates(hidden)
        vals, ids = topk_desc(ops.gam_score(h, self.raw_embed, mask), kappa)
        return vals, ids, mask

    def discard_fraction(self, hidden: torch.Tensor) -> torch.Tensor:
        mask = self.candidates(hidden)
        return 1.0 - mask.float().mean(dim=-1)

    def snapshot(self, path: str) -> None:
        """Persist the vocab index through the retriever."""
        self.retriever.snapshot(path)
