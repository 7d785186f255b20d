"""Config registry of the port: ``get_config(arch_id)``.

The port runs the architectures it has a config file for: Mixtral-8x7B
and Qwen3-30B-A3B (MoE); Qwen3-14B, Gemma2-27B, Yi-6B and
DeepSeek-Coder-33B (dense SwiGLU); Hymba-1.5B (hybrid attention and Mamba
heads) and xLSTM-1.3B (mLSTM and sLSTM); plus the paper's Table-1
configs (``paper_conf1`` … ``paper_conf7``), with the aliases of
``repro/configs/__init__.py``.  The reference's ``hubert_xlarge`` and
``llava_next_mistral_7b`` (frame and mixed inputs) are not ported.
"""

from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.configs.paper_tables import PAPER_CONFS

ARCH_IDS = ["yi_6b", "qwen3_moe_30b_a3b", "xlstm_1_3b", "deepseek_coder_33b",
            "gemma2_27b", "mixtral_8x7b", "hymba_1_5b", "qwen3_14b"]

_ALIASES = {a.replace("_", "-"): a for a in ARCH_IDS}
_ALIASES.update({"xlstm-1.3b": "xlstm_1_3b", "hymba-1.5b": "hymba_1_5b"})


def get_config(arch_id: str) -> ModelConfig:
    key = _ALIASES.get(arch_id, arch_id)
    if key.startswith("paper_conf"):
        return PAPER_CONFS[key]
    if key not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; the port has {ARCH_IDS} "
                       f"and {sorted(PAPER_CONFS)}")
    return importlib.import_module(f"repro_torch.configs.{key}").CONFIG


__all__ = ["get_config", "ARCH_IDS", "ModelConfig", "TrainConfig",
           "PAPER_CONFS"]
