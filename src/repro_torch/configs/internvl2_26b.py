"""InternVL2-26B [arXiv:2404.16821]: InternLM2-20B language backbone; the
InternViT-6B vision encoder is a STUB — input_specs supplies patch
embeddings (d_frontend=3200) consumed through the MLP projector."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="internvl2-26b", family="vlm",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=16_384, vocab=92_553, d_frontend=3200, n_image_tokens=256,
)
