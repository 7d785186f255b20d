"""MoE transformer sublayer: router + MoEBlaze expert FFN, single device.

Mirrors ``repro/models/moe_block.py:_moe_local`` for
``moe_impl="blaze_pallas"``: top-k gating on float32 logits, the kernel
dispatch build, and the kernel-composed expert layer.  Other expert
implementations and the distribution modes are not ported yet and raise.
"""

from __future__ import annotations

import torch

from repro_torch.core import routing
from repro_torch.kernels.dispatch import build_dispatch
from repro_torch.kernels.ops import moe_ffn_blaze_pallas


def check_supported(cfg) -> None:
    """Raise for MoE settings the port does not run yet."""
    if cfg.moe_impl != "blaze_pallas":
        raise NotImplementedError(
            f"moe_impl={cfg.moe_impl!r} is not ported; the port runs "
            "'blaze_pallas' (ROADMAP queue A: the blaze / megablocks / dense "
            "expert layers come with the training slice)")
    if cfg.moe_parallel != "auto":
        raise NotImplementedError(
            f"moe_parallel={cfg.moe_parallel!r} is not ported; the port runs "
            "on one device (ROADMAP queue A, distribution)")
    if cfg.ffn_act != "swiglu":
        raise NotImplementedError(
            f"ffn_act={cfg.ffn_act!r}: the port's expert layer is SwiGLU")


def moe_local(xf: torch.Tensor, p: dict, cfg) -> torch.Tensor:
    """(L, d) token slab -> (L, d).  The auxiliary losses are training
    terms and are not computed on the serving path."""
    check_supported(cfg)
    g = routing.top_k_gating(xf, p["wg"], cfg.top_k)
    disp = build_dispatch(g.topk_experts.contiguous(), cfg.num_experts)
    gates = g.topk_weights.to(xf.dtype)
    return moe_ffn_blaze_pallas(xf, gates, disp, p["w1"], p["w3"], p["w2"])


def moe_sublayer(x: torch.Tensor, p: dict, cfg) -> torch.Tensor:
    """(B, S, d) -> (B, S, d)."""
    B, S, d = x.shape
    return moe_local(x.reshape(B * S, d), p, cfg).reshape(B, S, d)
