"""DeepSeek-V2-236B [arXiv:2405.04434]: MLA (kv_lora=512), 160 routed experts
top-6 + 2 shared, d_ff_expert=1536."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="deepseek-v2-236b", family="moe",
    n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128,
    d_ff=12_288, d_ff_expert=1536, vocab=102_400,
    n_experts=160, moe_top_k=6, n_shared_experts=2,
    use_mla=True, kv_lora=512, q_lora=1536, qk_nope_dim=128, qk_rope_dim=64,
    v_head_dim=128,
)
