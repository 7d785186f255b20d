"""The paper's Table-1 MoE configurations (conf1..conf7), field for field
from ``repro/configs/paper_tables.py``.  ffn_hidden = 4 x input_d.

Fields: (input_d, experts, top_k, batch, seq_len)."""

from repro_torch.configs.base import ModelConfig

_TABLE1 = {
    "paper_conf1": (512, 4, 1, 32, 2048),
    "paper_conf2": (1024, 8, 2, 32, 2048),
    "paper_conf3": (1024, 16, 4, 32, 2048),
    "paper_conf4": (2048, 16, 4, 32, 1024),
    "paper_conf5": (512, 16, 4, 32, 1024),
    "paper_conf6": (1024, 16, 4, 16, 1024),
    "paper_conf7": (2048, 8, 4, 16, 512),
}


def _mk(name, d, e, k, b, s):
    return ModelConfig(
        name=name, arch_type="moe", num_layers=1,
        d_model=d, num_heads=max(d // 128, 1), num_kv_heads=max(d // 128, 1),
        d_ff=0, vocab_size=32000,
        num_experts=e, top_k=k, moe_d_ff=4 * d,
        ffn_act="swiglu",
        block_pattern=("attn_moe",), dtype="float32",
    )


PAPER_CONFS = {n: _mk(n, *v) for n, v in _TABLE1.items()}
PAPER_TABLE1 = _TABLE1
