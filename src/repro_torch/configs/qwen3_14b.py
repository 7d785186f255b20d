"""Qwen3-14B: dense GQA with per-head qk-norm [hf:Qwen/Qwen3-8B family]."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-14b", arch_type="dense",
    num_layers=40, d_model=5120, num_heads=40, num_kv_heads=8,
    head_dim=128, d_ff=17408, vocab_size=151936,
    qk_norm=True, ffn_act="swiglu", rope_theta=1_000_000.0,
    block_pattern=("attn_ffn",),
    citation="hf:Qwen/Qwen3-8B",
)
