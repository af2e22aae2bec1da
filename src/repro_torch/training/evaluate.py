"""Evaluation harness: held-out perplexity and next-token accuracy.

Counterpart of ``repro.training.evaluate``.  It takes the batch dicts
``Model.loss`` takes, runs the forward under ``torch.no_grad()`` and sums
each batch's nll and top-1 hits in f32 on the model's device; the host
reads one pair of sums a batch.
"""
from __future__ import annotations

import math

import torch

__all__ = ["eval_batches", "EvalResult"]


def _eval_step(model, params, batch) -> tuple[torch.Tensor, torch.Tensor,
                                               int]:
    logits, labels, _ = model.shifted_logits(params, batch)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels[..., None])[..., 0]
    acc = (torch.argmax(logits, dim=-1) == labels).float()
    return nll.sum(), acc.sum(), nll.numel()


class EvalResult(dict):
    @property
    def ppl(self):
        return self["ppl"]


def eval_batches(model, params, batches) -> EvalResult:
    """batches: iterable of batch dicts.  Returns ppl / nll / top-1 acc and
    the number of tokens scored."""
    tot_nll, tot_acc, n = 0.0, 0.0, 0
    with torch.no_grad():
        for batch in batches:
            s_nll, s_acc, cnt = _eval_step(model, params, batch)
            tot_nll += float(s_nll)
            tot_acc += float(s_acc)
            n += int(cnt)
    nll = tot_nll / max(n, 1)
    return EvalResult(nll=nll, ppl=math.exp(min(nll, 30.0)),
                      top1_acc=tot_acc / max(n, 1), n_tokens=n)
