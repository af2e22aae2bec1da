"""Whisper-tiny [arXiv:2212.04356]: enc-dec; conv/mel frontend is a STUB —
input_specs supplies precomputed frame embeddings (d_frontend=80 mel bins)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="whisper-tiny", family="encdec",
    n_layers=4, n_encoder_layers=4, d_model=384, n_heads=6, n_kv_heads=6,
    head_dim=64, d_ff=1536, vocab=51_865, norm="ln", d_frontend=80,
)
