"""Serve a small LM on the port with batched requests, comparing the exact
LM head with the GAM-accelerated head (the paper's technique applied to
vocab retrieval), on the card unless given ``--device cpu``.  ``GamHead``
is a thin adapter over a unified-API ``gam-device`` retriever
(``repro_torch.retriever``) built on the unembedding rows.

Run:  PYTHONPATH=src python examples/serve_gam_torch.py [--device cpu]
"""
import argparse
import time

import numpy as np

from repro_torch.configs.registry import get_reduced_config
from repro_torch.models.model import Model
from repro_torch.serving import Engine, ServeConfig


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    device = ap.parse_args().device

    cfg = get_reduced_config("qwen2-1.5b").with_(vocab=4096,
                                                 tie_embeddings=False)
    model = Model(cfg, device=device)
    params = model.init(0)

    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab, (8, 16)).astype(np.int32)}

    exact = Engine(cfg, params, ServeConfig(max_new_tokens=16), capacity=64,
                   device=device)
    gam = Engine(cfg, params, ServeConfig(
        max_new_tokens=16, use_gam_head=True,
        gam_threshold=1.5, gam_min_overlap=2), capacity=64, device=device)

    t0 = time.time()
    r_exact = exact.generate(batch)
    t_exact = time.time() - t0
    t0 = time.time()
    r_gam = gam.generate(batch)
    t_gam = time.time() - t0

    agree = float(np.mean(r_exact.tokens == r_gam.tokens))
    print("batch of 8, 16 new tokens each")
    print(f"exact head: scored {cfg.vocab} vocab rows/step "
          f"({t_exact:.2f} s)")
    print(f"GAM head:   scored {r_gam.n_scored_vocab:.0f} vocab rows/step "
          f"({r_gam.discard_frac:.1%} discarded -> "
          f"x{1 / (1 - r_gam.discard_frac):.1f} head-matmul speed-up; "
          f"{t_gam:.2f} s)")
    print(f"greedy next-token agreement with exact decode: {agree:.1%}")
    assert r_gam.discard_frac > 0.05 and agree > 0.5
    print("OK")
    print("(for the sharded streaming retrieval service — live upserts, "
          "microbatched queries, snapshot/restore — see "
          "examples/serve_stream_torch.py)")


if __name__ == "__main__":
    main()
