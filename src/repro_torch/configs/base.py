"""Model/run configuration dataclasses of the port (a copy of
``repro.configs.base``)."""
from __future__ import annotations

import dataclasses
from typing import Literal

Family = Literal["dense", "moe", "ssm", "hybrid", "encdec", "vlm"]

__all__ = ["ModelConfig", "ShapeConfig", "reduced"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0              # 0 -> d_model // n_heads
    qkv_bias: bool = False
    norm: str = "rms"              # rms | ln | ln_nonparam
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    # attention variant (overridable per input shape)
    attn_kind: str = "full"        # full | sliding
    window: int = 4096
    q_chunk: int = 1024            # blockwise-attention chunk (perf knob)
    attn_f32: bool = True          # f32 score/softmax tensors (perf knob:
                                   # False stores scores in bf16)
    attn_truncate: bool = False    # causal KV truncation per q-chunk (perf
                                   # knob: unrolled chunk loop, static slices)
    fsdp: bool = True              # shard params/opt over data axis (ZeRO);
                                   # False = tensor-parallel only
    spec_overrides: tuple = ()     # ((path_regex, "replicate"), ...) —
                                   # per-arch sharding-rule overrides
    use_decode_kernel: bool = False  # flash-decode kernel for GQA decode
                                     # (its plain version on CPU tensors)
    # MoE
    n_experts: int = 0
    moe_top_k: int = 0
    n_shared_experts: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    # MLA (deepseek-v2)
    use_mla: bool = False
    kv_lora: int = 512
    q_lora: int = 1536
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    # SSM (mamba2 SSD)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_groups: int = 1
    ssm_chunk: int = 256
    conv_kernel: int = 4
    # hybrid (recurrentgemma): period-3 pattern (rec, rec, attn)
    lru_width: int = 0
    local_window: int = 2048
    # encoder-decoder (whisper)
    n_encoder_layers: int = 0
    d_frontend: int = 0            # stubbed modality-frontend embedding dim
    # vlm
    n_image_tokens: int = 0
    # numerics / perf
    dtype: str = "bfloat16"
    remat: str = "full"            # none | full | dots
    scan_layers: bool = True

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def vocab_padded(self) -> int:
        """Vocab rounded up so the unembedding shards cleanly on the model
        axis (production practice; un-shardable vocab replicates full-batch
        logits — a bug the roofline analysis caught, see EXPERIMENTS §Perf).
        Logit columns >= vocab are masked to -inf in Model._logits."""
        if self.vocab % 512 == 0 or self.vocab < 512:
            return self.vocab
        return ((self.vocab + 511) // 512) * 512

    @property
    def d_inner(self) -> int:       # SSM inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def param_count(self) -> int:
        """Analytic parameter count (used for MODEL_FLOPS in the roofline)."""
        d, L, V = self.d_model, self.n_layers, self.vocab
        emb = V * d * (1 if self.tie_embeddings else 2)
        if self.family == "ssm":
            di, g, n = self.d_inner, self.ssm_groups, self.ssm_state
            per = (d * (2 * di + 2 * g * n + self.ssm_heads)   # in_proj
                   + self.conv_kernel * (di + 2 * g * n)
                   + 3 * self.ssm_heads + di                    # A, D, dt_b, norm
                   + di * d)                                    # out_proj
            return emb + L * per
        hd = self.hd
        attn = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd \
            + self.n_heads * hd * d
        if self.use_mla:
            attn = (d * self.q_lora
                    + self.q_lora * self.n_heads * (self.qk_nope_dim + self.qk_rope_dim)
                    + d * (self.kv_lora + self.qk_rope_dim)
                    + self.kv_lora * self.n_heads * (self.qk_nope_dim + self.v_head_dim)
                    + self.n_heads * self.v_head_dim * d)
        if self.family == "moe":
            ffe = self.d_ff_expert or self.d_ff
            moe = self.n_experts * 3 * d * ffe + d * self.n_experts \
                + self.n_shared_experts * 3 * d * ffe
            per = attn + moe
        elif self.family == "hybrid":
            w = self.lru_width or d
            rec = d * 2 * w + 4 * w * 4 + 2 * w * w + w * d  # conv + gates + lru
            att = attn + 3 * d * self.d_ff
            per = (2 * rec + att) / 3 + 3 * d * self.d_ff * 0  # avg per layer
            per = per + 3 * d * self.d_ff * (1 / 3)
        else:
            per = attn + 3 * d * self.d_ff
        total = emb + int(L * per)
        if self.family == "encdec":
            total += self.n_encoder_layers * int(attn + 2 * d * self.d_ff) \
                + self.n_layers * int(attn)   # cross-attention
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE uses top-k + shared only)."""
        if self.family != "moe":
            return self.param_count()
        d, L = self.d_model, self.n_layers
        ffe = self.d_ff_expert or self.d_ff
        full = self.param_count()
        moe_all = L * self.n_experts * 3 * d * ffe
        moe_act = L * (self.moe_top_k + self.n_shared_experts) * 3 * d * ffe
        return full - moe_all + moe_act


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family variant for CPU smoke tests (brief: <=2 layers,
    d_model <= 512, <= 4 experts)."""
    kw: dict = dict(
        n_layers=2,
        d_model=256,
        n_heads=4,
        n_kv_heads=max(1, min(cfg.n_kv_heads, 4) if cfg.n_kv_heads else 4),
        head_dim=64,
        d_ff=512,
        vocab=512,
        dtype="float32",
        remat="none",
        q_chunk=64,
    )
    if cfg.family == "moe":
        # capacity_factor E/K makes dispatch dropless at smoke scale so the
        # prefill+decode == forward invariant is exact
        kw.update(n_experts=4, moe_top_k=2,
                  n_shared_experts=min(cfg.n_shared_experts, 1),
                  d_ff_expert=128, capacity_factor=2.0)
    if cfg.use_mla:
        kw.update(q_lora=128, kv_lora=64, qk_nope_dim=32, qk_rope_dim=16,
                  v_head_dim=32, head_dim=0)
    if cfg.family == "ssm":
        kw.update(ssm_state=16, ssm_head_dim=32, ssm_chunk=32, n_heads=1,
                  n_kv_heads=1, d_ff=0)
    if cfg.family == "hybrid":
        # small window so the ring-buffer cache path is exercised in smoke
        kw.update(lru_width=256, local_window=16, n_layers=3)
    if cfg.family == "encdec":
        kw.update(n_encoder_layers=2, d_frontend=cfg.d_frontend and 256)
    if cfg.family == "vlm":
        kw.update(n_image_tokens=8)
    return cfg.with_(**kw)
