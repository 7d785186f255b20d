"""Config registry of the port: ``get_config(arch_id)``.

The port runs the architectures it has a config file for: Mixtral-8x7B
and Qwen3-30B-A3B (MoE) and Qwen3-14B (dense SwiGLU), plus the paper's Table-1 configs
(``paper_conf1`` … ``paper_conf7``), as in ``repro/configs/__init__.py``.
"""

from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.configs.paper_tables import PAPER_CONFS

ARCH_IDS = ["mixtral_8x7b", "qwen3_14b", "qwen3_moe_30b_a3b"]

_ALIASES = {"mixtral-8x7b": "mixtral_8x7b", "qwen3-14b": "qwen3_14b",
            "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b"}


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
