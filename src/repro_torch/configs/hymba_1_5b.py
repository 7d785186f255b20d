"""Hymba-1.5B: hybrid heads — attention and Mamba heads run in parallel on
the same input and are mean-fused; sliding-window attention on the
attention heads; ssm_state=16 [arXiv:2411.13676].

As in the reference's config, every layer uses sliding-window attention
(Hymba itself keeps three full-attention layers), and attention runs in
128-token KV chunks.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", arch_type="hybrid",
    num_layers=32, d_model=1600, num_heads=25, num_kv_heads=5,
    head_dim=64, d_ff=5504, vocab_size=32001,
    ffn_act="swiglu", sliding_window=1024,
    ssm_state=16, ssm_heads=25,
    block_pattern=("hymba",),
    attn_chunk=128,
    citation="arXiv:2411.13676",
)
