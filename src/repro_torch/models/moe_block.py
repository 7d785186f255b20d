"""MoE transformer sublayer: router + MoEBlaze expert FFN, single device.

Mirrors ``repro/models/moe_block.py:_moe_local`` for
``moe_impl="blaze_pallas"``: top-k gating on float32 logits, the kernel
dispatch build, the kernel-composed expert layer with its Algorithm-1
backward, and the auxiliary load-balance and router z losses.  Other
expert implementations and the distribution modes are not ported yet and
raise.

The expert weights are cast to the activations' dtype before the layer,
where the reference multiplies bf16 activations by its float32 expert
weights (``moe_block.py:165-166``; ``jnp.dot`` promotes to float32).  The
port keeps the expert GEMMs on bf16 tensor cores; the gradients flow back
to the float32 masters through the cast.  ``tests/test_torch_train.py``
bounds the difference in bf16.
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
            "'blaze_pallas' (ROADMAP queue A2: the blaze / megablocks / dense "
            "expert layers)")
    if cfg.moe_parallel != "auto":
        raise NotImplementedError(
            f"moe_parallel={cfg.moe_parallel!r} is not ported; the port runs "
            "on one device (ROADMAP queue A, distribution)")
    if cfg.ffn_act != "swiglu":
        raise NotImplementedError(
            f"ffn_act={cfg.ffn_act!r}: the port's expert layer is SwiGLU")
    # The kernel composition saves a fixed residual set (a, b, y_swi); the
    # reference refuses plans whose moe-scoped residual mode differs.  The
    # port has no checkpoint plans yet, so only the plan without remat.
    if cfg.remat_policy != "none":
        raise NotImplementedError(
            f"remat_policy={cfg.remat_policy!r}: checkpoint plans are not "
            "ported (ROADMAP queue A4); the port runs remat_policy='none'")


def _aux_of(g: routing.GatingOut, cfg) -> torch.Tensor:
    return (cfg.aux_loss_weight
            * routing.load_balance_loss(g.router_probs, g.topk_experts,
                                        cfg.num_experts)
            + cfg.z_loss_weight * routing.router_z_loss(g.logits))


def moe_local(xf: torch.Tensor, p: dict, cfg):
    """(L, d) token slab -> ((L, d), aux loss)."""
    check_supported(cfg)
    dt = xf.dtype
    g = routing.top_k_gating(xf, p["wg"].to(dt), cfg.top_k)
    disp = build_dispatch(g.topk_experts.contiguous(), cfg.num_experts)
    gates = g.topk_weights.to(dt)
    y = moe_ffn_blaze_pallas(xf, gates, disp, p["w1"].to(dt),
                             p["w3"].to(dt), p["w2"].to(dt))
    return y, _aux_of(g, cfg)


def moe_sublayer(x: torch.Tensor, p: dict, cfg):
    """(B, S, d) -> ((B, S, d), aux loss)."""
    B, S, d = x.shape
    y, aux = moe_local(x.reshape(B * S, d), p, cfg)
    return y.reshape(B, S, d), aux
