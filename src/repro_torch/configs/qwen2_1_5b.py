"""Qwen2-1.5B [arXiv:2407.10671]: GQA (2 KV heads), QKV bias, tied embeddings."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen2-1.5b", family="dense",
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2, head_dim=128,
    d_ff=8960, vocab=151_936, qkv_bias=True, tie_embeddings=True,
    rope_theta=1_000_000.0,
)
