"""Gemma2-27B: alternating local(4096)/global attention, logit softcaps,
sandwich norms [arXiv:2408.00118]."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b", arch_type="dense",
    num_layers=46, d_model=4608, num_heads=32, num_kv_heads=16,
    head_dim=128, d_ff=36864, vocab_size=256000,
    ffn_act="swiglu",
    sliding_window=4096, local_global_period=2,
    attn_softcap=50.0, final_softcap=30.0, post_norms=True,
    block_pattern=("attn_local_ffn", "attn_ffn"),
    citation="arXiv:2408.00118",
)
