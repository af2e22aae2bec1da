"""Training launcher of the port: end-to-end LM training on one device.

Counterpart of ``repro.launch.train``, with the same flags and one more:
``--device {cuda,cpu}`` (default ``cuda``; without a card the launcher
raises unless given ``--device cpu``).  It trains any family of the
registry on the synthetic token pipeline, evaluates 4 held-out batches
(pipeline seed + 10,000) and, with ``--ckpt``, saves ``{"params": ...}``
in the checkpoint format both packages read.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
      --reduced --steps 200 --batch 8 --seq 128 [--ckpt out.npz]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs.registry import (ARCH_IDS, get_config,
                                          get_reduced_config)
from repro_torch.data import TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_train_step
from repro_torch.models.model import Model
from repro_torch.training.evaluate import eval_batches
from repro_torch.training.optimizer import (AdamWConfig, adamw_init,
                                            tree_leaves)

__all__ = ["build_batch", "train", "main"]


def build_batch(cfg, tokens: np.ndarray, rng: np.random.Generator,
                device=None) -> dict:
    """A train batch on ``device`` (default the card): the (B, S+1) tokens,
    and the family's extras drawn from ``rng`` as the reference draws them
    (frames (B, S, d_frontend) for encdec, image embeddings for vlm)."""
    dev = resolve_device(device)
    batch = {"tokens": torch.as_tensor(tokens, device=dev)}
    b, s = tokens.shape[0], tokens.shape[1] - 1
    if cfg.family == "encdec":
        batch["frames"] = torch.as_tensor(
            rng.normal(size=(b, s, cfg.d_frontend)).astype(np.float32),
            device=dev)
    if cfg.family == "vlm":
        batch["image_embeds"] = torch.as_tensor(
            rng.normal(size=(b, cfg.n_image_tokens, cfg.d_frontend))
            .astype(np.float32), device=dev)
    return batch


def train(arch: str, *, reduced: bool, steps: int, batch_size: int,
          seq: int, lr: float = 3e-4, ckpt: str | None = None,
          vocab: int | None = None, d_model: int | None = None,
          n_layers: int | None = None, d_ff: int | None = None,
          log_every: int = 10, seed: int = 0, device=None) -> list[float]:
    """Train ``arch`` for ``steps`` steps on ``device`` (default the card);
    returns every step's loss."""
    dev = resolve_device(device)
    cfg = get_reduced_config(arch) if reduced else get_config(arch)
    overrides = {}
    if vocab:
        overrides["vocab"] = vocab
    if d_model:
        overrides["d_model"] = d_model
        overrides["head_dim"] = max(d_model // cfg.n_heads, 8)
    if n_layers:
        overrides["n_layers"] = n_layers
    if d_ff:
        overrides["d_ff"] = d_ff
    if overrides:
        cfg = cfg.with_(**overrides)
    model = Model(cfg, device=dev)
    params = model.init(seed)
    n_params = sum(x.numel() for x in tree_leaves(params))
    print(f"arch={cfg.arch_id} params={n_params/1e6:.1f}M "
          f"(family={cfg.family})", flush=True)

    opt_cfg = AdamWConfig(lr=lr, warmup_steps=min(50, steps // 5),
                          total_steps=steps)
    opt_state = adamw_init(params)
    step_fn = make_train_step(model, opt_cfg)

    text_len = seq
    pipe = TokenPipeline(vocab=cfg.vocab, seq_len=text_len, batch=batch_size,
                         seed=seed)
    rng = np.random.default_rng(seed)
    losses = []
    t0 = time.monotonic()
    for step, tokens in zip(range(steps), pipe):
        batch = build_batch(cfg, tokens, rng, dev)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        losses.append(float(metrics["loss"]))
        if step % log_every == 0 or step == steps - 1:
            dt = time.monotonic() - t0
            print(f"step {step:5d} loss {losses[-1]:.4f} "
                  f"nll {float(metrics['nll']):.4f} "
                  f"lr {float(metrics['lr']):.2e} "
                  f"({dt/max(step,1):.2f}s/step)", flush=True)
    # held-out evaluation (different pipeline seed => unseen stream)
    eval_pipe = TokenPipeline(vocab=cfg.vocab, seq_len=text_len,
                              batch=batch_size, seed=seed + 10_000)
    held_out = [build_batch(cfg, t, rng, dev)
                for t, _ in zip(eval_pipe, range(4))]
    res = eval_batches(model, params, held_out)
    print(f"eval: ppl {res['ppl']:.2f} nll {res['nll']:.4f} "
          f"top1 {res['top1_acc']:.3f} over {res['n_tokens']} tokens",
          flush=True)
    if ckpt:
        save_checkpoint(ckpt, {"params": params}, step=steps)
        print(f"checkpoint -> {ckpt}")
    return losses


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="tinyllama-1.1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--vocab", type=int)
    ap.add_argument("--d-model", type=int)
    ap.add_argument("--n-layers", type=int)
    ap.add_argument("--ckpt")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the model trains (default: the card; cpu "
                         "runs the plain PyTorch path)")
    args = ap.parse_args()
    resolve_device(args.device)
    losses = train(args.arch, reduced=args.reduced, steps=args.steps,
                   batch_size=args.batch, seq=args.seq, lr=args.lr,
                   ckpt=args.ckpt, vocab=args.vocab, d_model=args.d_model,
                   n_layers=args.n_layers, device=args.device)
    print(f"final loss {losses[-1]:.4f} (from {losses[0]:.4f})")


if __name__ == "__main__":
    main()
