"""Mixtral-8x7B: 8-expert top-2 MoE with sliding-window attention
[arXiv:2401.04088]."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b", arch_type="moe",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    head_dim=128, d_ff=0, vocab_size=32000,
    num_experts=8, top_k=2, moe_d_ff=14336,
    sliding_window=4096, ffn_act="swiglu", rope_theta=1_000_000.0,
    block_pattern=("attn_local_moe",),
    citation="arXiv:2401.04088",
)
