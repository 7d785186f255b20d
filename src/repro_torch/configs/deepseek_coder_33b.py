"""DeepSeek-Coder-33B: llama-architecture dense with GQA kv=8
[arXiv:2401.14196]."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-coder-33b", arch_type="dense",
    num_layers=62, d_model=7168, num_heads=56, num_kv_heads=8,
    head_dim=128, d_ff=19200, vocab_size=32256,
    ffn_act="swiglu", rope_theta=100_000.0,
    block_pattern=("attn_ffn",),
    citation="arXiv:2401.14196",
)
