"""OLMo-1B [arXiv:2402.00838]: non-parametric LayerNorm, tied embeddings."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="olmo-1b", family="dense",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=8192, vocab=50_304, norm="ln_nonparam", tie_embeddings=True,
)
