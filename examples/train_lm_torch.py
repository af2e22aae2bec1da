"""End-to-end run on the port: train a ~100M-parameter LM for a few
hundred steps on the synthetic token pipeline, checkpoint it, and reload.

This exercises the port's training substrate: model zoo, data pipeline,
AdamW, cosine schedule, gradient clipping, checkpointing.  It runs on the
card unless given ``--device cpu``.

Run:  PYTHONPATH=src python examples/train_lm_torch.py [--steps 300]
"""
import argparse
import os
import tempfile

from repro_torch.checkpoint import restore_checkpoint
from repro_torch.configs.registry import get_config
from repro_torch.launch.train import train
from repro_torch.models.model import Model


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=250)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args()

    # ~100M params: olmo-family, 8 layers, d_model 768, vocab 50304
    ckpt = os.path.join(tempfile.gettempdir(), "train_lm_torch_example.npz")
    losses = train(
        "olmo-1b", reduced=False, steps=args.steps, batch_size=args.batch,
        seq=args.seq, lr=1e-3, ckpt=ckpt,
        d_model=768, n_layers=8, d_ff=3072, vocab=50_304, device=args.device,
    )
    assert losses[-1] < 0.8 * losses[0], (losses[0], losses[-1])
    print(f"loss {losses[0]:.3f} -> {losses[-1]:.3f} over {args.steps} steps")

    # restore round-trip
    cfg = get_config("olmo-1b").with_(
        d_model=768, head_dim=768 // 16, n_layers=8, d_ff=3072, vocab=50_304)
    model = Model(cfg, device=args.device)
    like = {"params": model.init(0)}
    restored, step = restore_checkpoint(ckpt, like)
    print(f"checkpoint restored at step {step}: OK")


if __name__ == "__main__":
    main()
