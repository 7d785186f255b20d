"""Input shapes for every (architecture x input shape) pair, as tensors on
the ``meta`` device: the shapes and dtypes of a step's arguments, with no
storage.  The counterpart of ``repro/launch/specs.py``, whose
``ShapeDtypeStruct`` trees these mirror leaf for leaf; the decode cache
is the port's per-layer layout (``models/transformer.init_cache``), where
the reference stacks each pattern position's leaves over the layer
groups.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.interop import init_params
from repro_torch.models import transformer as T

META = torch.device("meta")


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def batch_shapes(cfg: ModelConfig, shape: InputShape) -> dict:
    """Training / prefill batch of one global batch."""
    B, S = shape.global_batch, shape.seq_len
    i32, f32 = torch.int32, torch.float32
    if cfg.input_kind == "tokens":
        return {"tokens": _sds((B, S), i32), "labels": _sds((B, S), i32)}
    if cfg.input_kind == "frames":
        return {"features": _sds((B, S, cfg.d_model), f32),
                "labels": _sds((B, S), i32)}
    if cfg.input_kind == "mixed":
        n_img = min(cfg.num_image_tokens, S // 2)
        return {"image_embeds": _sds((B, n_img, cfg.d_model), f32),
                "tokens": _sds((B, S - n_img), i32),
                "labels": _sds((B, S - n_img), i32)}
    raise ValueError(cfg.input_kind)


def decode_shapes(cfg: ModelConfig, shape: InputShape) -> dict:
    """Decode-step inputs: one new token a row and a ``seq_len``-capacity
    cache (``transformer.init_cache`` on the meta device)."""
    B, S = shape.global_batch, shape.seq_len
    return {"tokens": _sds((B, 1), torch.int32),
            "cache": T.init_cache(cfg, B, S, META),
            "pos": _sds((), torch.int32)}


def params_shapes(cfg: ModelConfig) -> dict:
    """The parameter tree as training holds it (``cfg.param_dtype``
    matrices), on the meta device."""
    return init_params(cfg, device=META, dtype=getattr(torch,
                                                       cfg.param_dtype))


def applicable(cfg: ModelConfig, shape: InputShape) -> str | None:
    """None if the pair runs, else the reason it is skipped (the
    reference's words)."""
    if shape.kind == "decode":
        if not cfg.causal or cfg.input_kind == "frames":
            return "encoder-only: no autoregressive decode"
        if shape.name == "long_500k":
            sub_quadratic = (
                cfg.arch_type in ("ssm", "hybrid")
                or cfg.sliding_window > 0)
            if not sub_quadratic:
                return "pure full attention: no sub-quadratic variant"
    return None
