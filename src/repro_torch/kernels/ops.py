"""The MoEBlaze expert layer composed from the kernels (forward only).

Mirrors the forward of ``repro/kernels/ops.py:moe_ffn_blaze_pallas``
(``_moe_pallas_fwd``): gather-GMM with the dual SwiGLU epilogue, the second
grouped GEMM over identity rows (already in expert order), then the
gather-of-partials combine.  The routed ``(L*k, d)`` input never exists.
The backward (an autograd ``Function`` over the training kernels) belongs
to the training slice; until then an input that requires grad raises.
"""

from __future__ import annotations

import torch

from repro_torch.core.routing import Dispatch
from repro_torch.kernels.combine import combine
from repro_torch.kernels.gather_gmm import gather_gmm


def moe_ffn_blaze_pallas(x: torch.Tensor, gates: torch.Tensor,
                         dispatch: Dispatch, w1: torch.Tensor,
                         w3: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """SwiGLU expert layer: x (L, d), gates (L, k), w1/w2 (E, d, h),
    w3 (E, h, d) -> (L, d) in ``x.dtype``."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, gates, w1, w2, w3)):
        raise NotImplementedError(
            "moe_ffn_blaze_pallas is forward-only in the port; its backward "
            "comes with the training slice (ROADMAP queue A)")
    d = dispatch
    y_swi = gather_gmm(x, d.expert_token_indices, d.expert_token_offsets,
                       w1, w2)
    p_out = gather_gmm(y_swi, None, d.expert_token_offsets, w3,
                       epilogue=False)
    return combine(p_out, d.token_index_map, gates.to(x.dtype).contiguous())
