"""Baseline MoE layers MoEBlaze is compared against (paper §6.2).

Mirrors ``repro/core/baseline.py``.  Neither is a Pallas kernel in the
reference, so both are plain PyTorch here; the grouped GEMMs go through
the resolved backend of ``core/gmm_backend.py`` (the hand-written kernels
under ``pallas``).

* :func:`moe_ffn_megablocks`: MegaBlocks-style **materialized** dispatch.
  Tokens are gathered into a compacted (L·k, d) routed buffer, three
  grouped GEMMs run on it, and the gated outputs are scatter-added back.
  Plain autograd differentiates it, with no hand-written backward, so it
  saves the routed buffer and every intermediate autograd keeps: the
  activation footprint the paper attributes to conventional systems
  (§2.1, §2.2).
* :func:`moe_ffn_dense`: GShard-style dense dispatch (every expert
  processes every token, masked).  O(L·E) compute; a small-scale oracle.
"""

from __future__ import annotations

import torch

from repro_torch.core.gmm_backend import ResolvedBackend, gmm, resolve
from repro_torch.core.moe_layer import _ACTS
from repro_torch.core.routing import Dispatch
from repro_torch.kernels.fused_moe import _silu


def moe_ffn_megablocks(x: torch.Tensor, gates: torch.Tensor,
                       dispatch: Dispatch, w1: torch.Tensor,
                       w3: torch.Tensor, w2: torch.Tensor | None = None,
                       *, activation: str = "swiglu",
                       backend: str | ResolvedBackend | None = None
                       ) -> torch.Tensor:
    """Materialized-dispatch baseline (plain autograd, no smart
    checkpoint).  x: (L, d); gates: (L, k); w1 (and w2): (E, d, h); w3:
    (E, h, d) -> (L, d) in ``x.dtype``."""
    # One resolution shared by the three grouped GEMMs and their backward.
    backend = resolve(backend)
    L, k = dispatch.token_index_map.shape
    eti = dispatch.expert_token_indices.long()
    lens = dispatch.expert_lengths
    # The (L*k, d) routed-token buffer that MoEBlaze never materializes.
    xg = x.index_select(0, eti)
    a = gmm(xg, w1, lens, backend=backend)
    if activation == "swiglu":
        if w2 is None:
            raise ValueError("the SwiGLU expert layer needs w2")
        b = gmm(xg, w2, lens, backend=backend)
        y_act = _silu(a) * b
    else:
        y_act = _ACTS[activation][0](a)
    p_out = gmm(y_act, w3, lens, backend=backend)
    g_slot = gates.new_zeros(L * k).scatter(
        0, dispatch.token_index_map.reshape(-1).long(), gates.reshape(-1))
    # Scatter-add combine on the materialized buffer.
    return torch.zeros_like(x).index_add(
        0, eti, (p_out * g_slot[:, None].to(p_out.dtype)).to(x.dtype))


def moe_ffn_dense(x: torch.Tensor, router_probs: torch.Tensor,
                  topk_experts: torch.Tensor, topk_weights: torch.Tensor,
                  w1: torch.Tensor, w3: torch.Tensor,
                  w2: torch.Tensor | None = None,
                  *, activation: str = "swiglu") -> torch.Tensor:
    """GShard-style dense dispatch: O(L·E·d·h) masked compute (an
    oracle).  ``router_probs`` is unused, as in the reference."""
    E = w1.shape[0]
    # (L, E) combine weights: the top-k gate weight where chosen, else 0.
    cw = topk_weights.new_zeros(x.shape[0], E).scatter(
        1, topk_experts.long(), topk_weights)
    a = torch.einsum("ld,edh->leh", x, w1)
    if activation == "swiglu":
        if w2 is None:
            raise ValueError("the SwiGLU expert layer needs w2")
        b = torch.einsum("ld,edh->leh", x, w2)
        y_act = _silu(a) * b
    else:
        y_act = _ACTS[activation][0](a)
    p = torch.einsum("leh,ehd->led", y_act, w3)
    return torch.einsum("le,led->ld", cw.to(p.dtype), p).to(x.dtype)
