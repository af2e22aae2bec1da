"""Batched serving engine: prefill + decode loop over a KV cache, greedy or
temperature sampling, and the GAM-accelerated LM head.

Counterpart of ``repro.serving.engine``.  With ``use_gam_head=True`` the
decode step stops at the final hidden state (no vocab matmul) and the GAM
head scores only the candidate vocabulary rows.

Greedy picks break ties by the LOWEST vocab id, as ``lax.top_k`` + argmax
do in the reference: the top-kappa is taken under (score desc, id asc) by
``topk_desc`` (``torch.topk`` promises no order among equal values on the
card), and the pick is its first entry.  Temperature sampling draws from an
explicit ``torch.Generator``; only greedy decoding is held to the reference.

Tokens stay on the device between steps; the host reads them once, after
the last step.  On the card, CUDA events around the prefill and each decode
step give device-clock times (``GenerationResult.prefill_ms``/``step_ms``),
read after the last step.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.retrieval import topk_desc
from repro_torch.models.model import Model
from repro_torch.serving.gam_head import GamHead

__all__ = ["ServeConfig", "Engine", "GenerationResult"]


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    max_new_tokens: int = 32
    kappa: int = 8              # candidate set size for sampling
    temperature: float = 0.0    # 0 => greedy
    use_gam_head: bool = False
    gam_threshold: float = 1.5
    gam_min_overlap: int = 2


@dataclasses.dataclass
class GenerationResult:
    tokens: np.ndarray          # (B, T_new)
    n_scored_vocab: float       # mean vocab rows scored per step
    discard_frac: float         # mean fraction of vocab discarded per step
    prefill_ms: float | None = None   # card only: prefill + first pick
    step_ms: list | None = None       # card only: each decode step


class Engine:
    def __init__(self, cfg: ModelConfig, params, serve_cfg: ServeConfig,
                 capacity: int = 256, device=None):
        self.cfg = cfg
        self.model = Model(cfg, device)
        self.device = self.model.device
        self.params = params
        self.serve_cfg = serve_cfg
        self.capacity = capacity
        self.gam_head: GamHead | None = None
        if serve_cfg.use_gam_head:
            embed = (params["embed"] if cfg.tie_embeddings
                     else params["lm_head"].T)
            # drop the padding rows of the padded vocab from the index
            self.gam_head = GamHead.build(
                embed[: cfg.vocab], threshold=serve_cfg.gam_threshold,
                min_overlap=serve_cfg.gam_min_overlap, device=self.device)

    def _pick(self, vals: torch.Tensor, ids: torch.Tensor,
              gen: torch.Generator | None) -> torch.Tensor:
        """(B, K) candidate scores (desc, id asc) -> (B, 1) token ids."""
        if self.serve_cfg.temperature <= 0.0:
            return ids[:, :1]
        probs = torch.softmax(vals / self.serve_cfg.temperature, dim=-1)
        col = torch.multinomial(probs, 1, generator=gen)
        return torch.gather(ids, 1, col)

    def generate(self, batch: dict, seed: int = 0) -> GenerationResult:
        """batch: dict with 'tokens' (B, S_prompt) prompt ids."""
        sc = self.serve_cfg
        gen = None
        if sc.temperature > 0.0:
            gen = torch.Generator(device=self.device).manual_seed(seed)
        timed = self.device.type == "cuda"
        marks = []

        def mark():
            if timed:
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                marks.append(ev)

        mark()
        logits0, cache = self.model.prefill(self.params, batch, self.capacity)
        vals0, ids0 = topk_desc(logits0[:, 0], sc.kappa)
        tok = self._pick(vals0, ids0, gen)
        mark()
        out = [tok]
        scored, n_masks = [], []
        for _ in range(sc.max_new_tokens - 1):
            if self.gam_head is not None:
                hidden, cache = self.model.decode_step(
                    self.params, cache, tok, return_hidden=True)
                vals, ids, mask = self.gam_head.topk(hidden[:, 0], sc.kappa)
                scored.append(mask.sum(dim=-1))
                n_masks.append(mask.numel())
            else:
                logits, cache = self.model.decode_step(self.params, cache,
                                                       tok)
                vals, ids = topk_desc(logits[:, 0], sc.kappa)
            tok = self._pick(vals, ids, gen)
            out.append(tok)
            mark()
        tokens = torch.cat(out, dim=1).cpu().numpy().astype(np.int32)
        times = ([a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
                 if timed else None)
        if scored:
            counts = torch.stack(scored).cpu().numpy()       # (steps, B)
            # per step as the reference computes it in f32: the mean count,
            # and 1 - (candidates / B V)
            n_scored = float(np.mean(
                counts.mean(axis=1, dtype=np.float32).astype(np.float64)))
            discard = float(np.mean([
                1.0 - float(np.float32(c.sum()) / np.float32(n))
                for c, n in zip(counts, n_masks)]))
        else:
            n_scored, discard = float(self.cfg.vocab), 0.0
        return GenerationResult(
            tokens=tokens, n_scored_vocab=n_scored, discard_frac=discard,
            prefill_ms=times[0] if times else None,
            step_ms=times[1:] if times else None)
