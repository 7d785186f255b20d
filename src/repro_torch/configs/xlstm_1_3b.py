"""xLSTM-1.3B: sLSTM + mLSTM blocks (one sLSTM per 8 layers)
[arXiv:2405.04517]."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b", arch_type="ssm",
    num_layers=48, d_model=2048, num_heads=4, num_kv_heads=4,
    head_dim=512, d_ff=0, vocab_size=50304,
    block_pattern=("mlstm",) * 7 + ("slstm",),
    slstm_every=8,
    citation="arXiv:2405.04517",
)
