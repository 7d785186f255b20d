"""Dense FFN sublayer.

Mirrors ``repro/models/ffn.py:ffn_sublayer``.  The SwiGLU variant applies
the paper's fusion and checkpoint policy (save ``a`` and ``b``, recompute
SiLU): through the fused kernels' autograd Function (``kernels/ops.swiglu``)
when ``cfg.use_pallas``, else as plain ``a``, ``b``, ``silu(a) b``.  The
other activations have no ``w2``; ``gelu`` is the tanh form, as
``jax.nn.gelu``'s default.  On the plain path the products and the SwiGLU
product are the producers of the checkpoint tags ``FFN_A``, ``FFN_B`` and
``FFN_YSWI``, as the reference tags them; the fused Function keeps its own
residuals.  The second product ``y @ w3`` is a plain
matmul, as the reference leaves it outside any Pallas kernel.  Weights
are cast to the activations' dtype on use, as the reference does, so the
port and the reference round the same way.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.checkpoint import FFN_A, FFN_B, FFN_YSWI, tagged
from repro_torch.kernels.ops import swiglu

FFN_ACTS = ("swiglu", "gelu", "relu", "silu")

_ACTS = {"gelu": lambda a: F.gelu(a, approximate="tanh"), "relu": F.relu,
         "silu": F.silu}


def ffn_sublayer(x: torch.Tensor, p: dict, cfg) -> torch.Tensor:
    """(B, S, d) -> (B, S, d)."""
    B, S, d = x.shape
    dt = x.dtype
    xf = x.reshape(B * S, d)
    w1 = p["w1"].to(dt)
    if cfg.ffn_act == "swiglu" and cfg.use_pallas:
        y = swiglu(xf, w1, p["w2"].to(dt))
    elif cfg.ffn_act == "swiglu":
        w2 = p["w2"].to(dt)
        with tagged(FFN_A):
            a = xf @ w1
        with tagged(FFN_B):
            b = xf @ w2
        sa = F.silu(a)
        with tagged(FFN_YSWI):
            y = sa * b
    else:
        with tagged(FFN_A):
            a = xf @ w1
        y = _ACTS[cfg.ffn_act](a)
    return (y @ p["w3"].to(dt)).reshape(B, S, d)
