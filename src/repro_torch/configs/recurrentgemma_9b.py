"""RecurrentGemma-9B [arXiv:2402.19427]: RG-LRU + local attention (MQA kv=1),
pattern 2 recurrent : 1 local-attn, window 2048."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="recurrentgemma-9b", family="hybrid",
    n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1, head_dim=256,
    d_ff=12_288, vocab=256_000, lru_width=4096, local_window=2048,
    tie_embeddings=True,
    conv_kernel=4,
)
