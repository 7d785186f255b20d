"""Qwen3-30B-A3B: 128-expert top-8 MoE with GQA + qk-norm
[hf:Qwen/Qwen3-30B-A3B]."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b", arch_type="moe",
    num_layers=48, d_model=2048, num_heads=32, num_kv_heads=4,
    head_dim=128, d_ff=0, vocab_size=151936,
    num_experts=128, top_k=8, moe_d_ff=768,
    qk_norm=True, ffn_act="swiglu", rope_theta=1_000_000.0,
    block_pattern=("attn_moe",),
    citation="hf:Qwen/Qwen3-30B-A3B",
)
