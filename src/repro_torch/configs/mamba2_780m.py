"""Mamba2-780m [arXiv:2405.21060]: SSD, attention-free, state=128."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="mamba2-780m", family="ssm",
    n_layers=48, d_model=1536, n_heads=1, n_kv_heads=1, d_ff=0,
    vocab=50_280, ssm_state=128, ssm_head_dim=64, ssm_expand=2,
    ssm_groups=1, ssm_chunk=256, conv_kernel=4,
)
