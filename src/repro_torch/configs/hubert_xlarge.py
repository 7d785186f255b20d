"""HuBERT-XLarge: encoder-only audio transformer (the wav2vec 2.0
architecture); bidirectional attention, a GELU FFN, 16 heads of 80.  The
convolutional frontend is a stub, as in the reference: a batch holds frame
embeddings (``features``, one d-wide row per 20 ms frame), projected by
``frontend_proj`` [arXiv:2106.07447]."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge", arch_type="audio",
    num_layers=48, d_model=1280, num_heads=16, num_kv_heads=16,
    head_dim=80, d_ff=5120, vocab_size=504,
    ffn_act="gelu", causal=False, input_kind="frames",
    block_pattern=("attn_ffn",),
    citation="arXiv:2106.07447",
)
