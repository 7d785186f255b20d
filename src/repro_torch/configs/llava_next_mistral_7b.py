"""LLaVA-NeXT (Mistral-7B backbone): a dense SwiGLU GQA decoder over
anyres-tiled patch embeddings from a stubbed vision tower and projector
[hf:llava-hf/llava-v1.6-mistral-7b-hf].

Anyres tiling: a base 24x24 = 576-patch view plus up to four 576-patch
tiles, 2880 image-token slots (``num_image_tokens``).  A batch holds the
patch embeddings (``image_embeds``, projected by ``img_proj``) ahead of
the text tokens.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b", arch_type="vlm",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    head_dim=128, d_ff=14336, vocab_size=32000,
    ffn_act="swiglu", rope_theta=1_000_000.0,
    input_kind="mixed", num_image_tokens=2880,
    block_pattern=("attn_ffn",),
    citation="hf:llava-hf/llava-v1.6-mistral-7b-hf",
)
