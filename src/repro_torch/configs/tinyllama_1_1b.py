"""TinyLlama-1.1B [arXiv:2401.02385]: llama2-arch small, GQA kv=4."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="tinyllama-1.1b", family="dense",
    n_layers=22, d_model=2048, n_heads=32, n_kv_heads=4, head_dim=64,
    d_ff=5632, vocab=32_000,
)
