"""MoE transformer sublayer: router + MoEBlaze expert FFN, single device.

Mirrors ``repro/models/moe_block.py:_moe_local`` for
``moe_impl="blaze_pallas"`` (the kernel-composed expert layer with its
Algorithm-1 backward) and ``moe_impl="blaze"`` (``core/moe_layer.py``
over the resolved grouped-GEMM backend): top-k gating on float32 logits,
the kernel dispatch build, the expert layer, and the auxiliary
load-balance and router z losses.  The other expert implementations and
the distribution modes are not ported yet and raise.

The dispatch kernel is bit-identical to the plain build, so ``blaze``
matches the reference's ``routing.build_dispatch`` while running no plain
version on the card.

The expert weights are cast to the activations' dtype before the layer,
where the reference multiplies bf16 activations by its float32 expert
weights (``moe_block.py:165-166``; ``jnp.dot`` promotes to float32).  The
port keeps the expert GEMMs on bf16 tensor cores; the gradients flow back
to the float32 masters through the cast.  ``tests/test_torch_train.py``
bounds the difference in bf16.
"""

from __future__ import annotations

import torch

from repro_torch.core import gmm_backend as GB
from repro_torch.core import routing
from repro_torch.core.moe_layer import moe_ffn_blaze
from repro_torch.kernels.dispatch import build_dispatch
from repro_torch.kernels.ops import moe_ffn_blaze_pallas

MOE_IMPLS = ("blaze", "blaze_pallas")
FFN_ACTS = ("swiglu", "silu", "relu", "gelu")


def check_supported(cfg) -> None:
    """Raise for MoE settings the port does not run yet."""
    if cfg.moe_impl not in MOE_IMPLS:
        raise NotImplementedError(
            f"moe_impl={cfg.moe_impl!r} is not ported; the port runs "
            f"{MOE_IMPLS} (ROADMAP queue A2: the megablocks / dense expert "
            "layers)")
    if cfg.moe_parallel != "auto":
        raise NotImplementedError(
            f"moe_parallel={cfg.moe_parallel!r} is not ported; the port runs "
            "on one device (ROADMAP queue A, distribution)")
    acts = FFN_ACTS if cfg.moe_impl == "blaze" else ("swiglu",)
    if cfg.ffn_act not in acts:
        raise NotImplementedError(
            f"ffn_act={cfg.ffn_act!r}: moe_impl={cfg.moe_impl!r} takes "
            f"{acts}")
    if cfg.moe_impl == "blaze":
        GB.resolve(config=cfg.gmm_backend)  # raises for an unavailable one
    # The residual set follows the checkpoint plan in the reference
    # (``moe_residual_mode``); the port has no plans yet and
    # ``transformer.check_supported`` refuses every ``remat_policy`` but
    # "none", whose mode is set by ``save_yswi``.


def _aux_of(g: routing.GatingOut, cfg) -> torch.Tensor:
    return (cfg.aux_loss_weight
            * routing.load_balance_loss(g.router_probs, g.topk_experts,
                                        cfg.num_experts)
            + cfg.z_loss_weight * routing.router_z_loss(g.logits))


def moe_local(xf: torch.Tensor, p: dict, cfg, backend=None):
    """(L, d) token slab -> ((L, d), aux loss).  ``backend`` enters the
    grouped-GEMM precedence chain at the call-site slot, ``cfg.gmm_backend``
    at the config slot (``moe_impl="blaze"`` only)."""
    check_supported(cfg)
    dt = xf.dtype
    g = routing.top_k_gating(xf, p["wg"].to(dt), cfg.top_k)
    disp = build_dispatch(g.topk_experts.contiguous(), cfg.num_experts)
    gates = g.topk_weights.to(dt)
    w2 = p["w2"].to(dt) if "w2" in p else None
    if cfg.moe_impl == "blaze_pallas":
        y = moe_ffn_blaze_pallas(xf, gates, disp, p["w1"].to(dt),
                                 p["w3"].to(dt), w2)
    else:
        rb = GB.resolve(backend, config=cfg.gmm_backend)
        y = moe_ffn_blaze(xf, gates, disp, p["w1"].to(dt), p["w3"].to(dt),
                          w2, activation=cfg.ffn_act,
                          residuals="ab_yswi" if cfg.save_yswi else "ab",
                          backend=rb)
    return y, _aux_of(g, cfg)


def moe_sublayer(x: torch.Tensor, p: dict, cfg):
    """(B, S, d) -> ((B, S, d), aux loss)."""
    B, S, d = x.shape
    y, aux = moe_local(x.reshape(B * S, d), p, cfg)
    return y.reshape(B, S, d), aux
