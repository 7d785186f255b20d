"""The MoEBlaze expert layer (paper §3, §5, Algorithm 1).

Mirrors ``repro/core/moe_layer.py``: tokens are never permuted into
per-expert buffers; the grouped GEMMs take rows gathered through
``dispatch.expert_token_indices`` and the combine gathers each token's k
partials through ``dispatch.token_index_map``.  The backward is a
hand-written autograd Function (Algorithm 1): it expands the output
gradient to the slots through the index metadata, recomputes SiLU(A) and
the input gather, and scatter-adds the token gradients.

Residual modes of the SwiGLU layer, as in the reference:

  * ``"ab_yswi"`` — save ``A``, ``B`` and ``Y_swi`` (Algorithm 1 line 11);
  * ``"ab"``      — save ``A`` and ``B``; recompute ``Y_swi``;
  * ``"x"``       — save neither; the backward re-runs both first-layer
    grouped GEMMs.

Every grouped GEMM goes through the resolved backend of
``core/gmm_backend.py``; a backend with the ``fused_moe`` capability
(``pallas_fused``) runs whole SwiGLU layers through the fused kernel pair
(``kernels.ops.moe_ffn_blaze_fused``), whose residuals (the inputs and the
slot gates) are below even the ``"x"`` mode.

``index_add_`` on the card adds in no fixed order, but each token row gets
k addends on a zero row; for k <= 2 the sum commutes exactly.
"""

from __future__ import annotations

import torch

from repro_torch.core.gmm_backend import ResolvedBackend, get_backend, resolve
from repro_torch.core.routing import Dispatch
from repro_torch.kernels.fused_moe import _dsilu, _silu

RESIDUAL_MODES = ("ab_yswi", "ab", "x")


def _gelu(a):
    # jax.nn.gelu's default: the tanh form
    return torch.nn.functional.gelu(a, approximate="tanh")


def _dgelu(a):
    # the exact derivative of the tanh form (what autodiff of the
    # reference's gelu gives), in float32
    af = a.float()
    c = 0.7978845608028654  # sqrt(2 / pi)
    t = torch.tanh(c * (af + 0.044715 * af ** 3))
    dt = 0.5 * (1.0 + t) + 0.5 * af * (1.0 - t * t) * c * (
        1.0 + 3 * 0.044715 * af * af)
    return dt.to(a.dtype)


_ACTS = {
    "silu": (_silu, _dsilu),
    "relu": (torch.relu, lambda a: (a > 0).to(a.dtype)),
    "gelu": (_gelu, _dgelu),
}


def _gate_per_slot(gates: torch.Tensor, tim: torch.Tensor,
                   num_slots: int) -> torch.Tensor:
    """Scatter the (L, k) gates into expert-order slots (S,)."""
    g = gates.new_zeros(num_slots)
    g[tim.reshape(-1).long()] = gates.reshape(-1)
    return g


def _combine(p_out, tim, gates):
    """Gather each token's k partials and contract them with its gates."""
    L, k = tim.shape
    parts = p_out[tim.reshape(-1).long()].reshape(L, k, -1)
    return torch.einsum("lk,lkd->ld", gates.float(),
                        parts.float()).to(p_out.dtype)


def _expand(t, eti):
    return t[eti.long()]


def _scatter_rows(x, eti, dxg):
    return torch.zeros_like(x).index_add_(0, eti.long(), dxg.to(x.dtype))


class _MoESwiGLU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, w2, w3, gates, eti, tim, lens, residuals, bk):
        S = eti.shape[0]
        xg = _expand(x, eti)
        a = bk.gmm(xg, w1, lens)
        b = bk.gmm(xg, w2, lens)
        y_swi = _silu(a) * b
        g_slot = _gate_per_slot(gates, tim, S)
        y = _combine(bk.gmm(y_swi, w3, lens), tim, gates)
        save_ab = residuals != "x"
        ctx.bk, ctx.residuals = bk, residuals
        ctx.save_for_backward(
            x, w1, w2, w3, gates, eti, tim, lens, g_slot,
            a if save_ab else None, b if save_ab else None,
            y_swi if residuals == "ab_yswi" else None)
        return y

    @staticmethod
    def backward(ctx, dy):
        bk = ctx.bk
        (x, w1, w2, w3, gates, eti, tim, lens, g_slot, a, b,
         y_swi) = ctx.saved_tensors
        if a is None:       # "x": replay the first-layer grouped GEMMs
            xg0 = _expand(x, eti)
            a = bk.gmm(xg0, w1, lens)
            b = bk.gmm(xg0, w2, lens)
        if y_swi is None:
            y_swi = _silu(a) * b
        dyg = _expand(dy.to(x.dtype), eti)
        g_col = g_slot[:, None].to(y_swi.dtype)
        dw3 = bk.gmm_dw(y_swi * g_col, dyg, lens)
        dyu = bk.gmm(dyg, w3.transpose(1, 2), lens)
        dgates_slot = (y_swi * dyu).sum(-1)
        dgates = dgates_slot[tim.reshape(-1).long()].reshape(gates.shape)
        dy_swi = dyu * g_slot[:, None].to(dyu.dtype)
        da = dy_swi * b * _dsilu(a)
        db = dy_swi * _silu(a)
        xg = _expand(x, eti)
        dw1 = bk.gmm_dw(xg, da, lens)
        dw2 = bk.gmm_dw(xg, db, lens)
        dxg = (bk.gmm(da, w1.transpose(1, 2), lens)
               + bk.gmm(db, w2.transpose(1, 2), lens))
        return (_scatter_rows(x, eti, dxg), dw1, dw2, dw3,
                dgates.to(gates.dtype), None, None, None, None, None)


class _MoEMLP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, w3, gates, eti, tim, lens, act, residuals, bk):
        f, _ = _ACTS[act]
        xg = _expand(x, eti)
        a = bk.gmm(xg, w1, lens)
        g_slot = _gate_per_slot(gates, tim, eti.shape[0])
        y = _combine(bk.gmm(f(a), w3, lens), tim, gates)
        ctx.bk, ctx.act = bk, act
        ctx.save_for_backward(x, w1, w3, gates, eti, tim, lens, g_slot,
                              a if residuals != "x" else None)
        return y

    @staticmethod
    def backward(ctx, dy):
        bk = ctx.bk
        f, df = _ACTS[ctx.act]
        x, w1, w3, gates, eti, tim, lens, g_slot, a = ctx.saved_tensors
        if a is None:       # "x": replay the first-layer grouped GEMM
            a = bk.gmm(_expand(x, eti), w1, lens)
        fa = f(a)
        dyg = _expand(dy.to(x.dtype), eti)
        dw3 = bk.gmm_dw(fa * g_slot[:, None].to(fa.dtype), dyg, lens)
        dyu = bk.gmm(dyg, w3.transpose(1, 2), lens)
        dgates_slot = (fa * dyu).sum(-1)
        dgates = dgates_slot[tim.reshape(-1).long()].reshape(gates.shape)
        da = dyu * g_slot[:, None].to(dyu.dtype) * df(a)
        xg = _expand(x, eti)
        dw1 = bk.gmm_dw(xg, da, lens)
        dxg = bk.gmm(da, w1.transpose(1, 2), lens)
        return (_scatter_rows(x, eti, dxg), dw1, dw3, dgates.to(gates.dtype),
                None, None, None, None, None, None)


def moe_ffn_blaze(x: torch.Tensor, gates: torch.Tensor, dispatch: Dispatch,
                  w1: torch.Tensor, w3: torch.Tensor,
                  w2: torch.Tensor | None = None, *,
                  activation: str = "swiglu", save_yswi: bool = True,
                  residuals: str | None = None,
                  backend: str | ResolvedBackend | None = None
                  ) -> torch.Tensor:
    """MoEBlaze expert FFN.

    x: (L, d) unpermuted activations; gates: (L, k); dispatch: the index
    metadata of ``build_dispatch``; w1 (and w2 for SwiGLU): (E, d, h);
    w3: (E, h, d).  ``activation`` is "swiglu" | "silu" | "relu" | "gelu";
    ``residuals`` is "ab_yswi" | "ab" | "x" (None falls back to the
    ``save_yswi`` alias); ``backend`` is a backend name, a
    ``ResolvedBackend``, or None to walk the precedence chain."""
    if residuals is None:
        residuals = "ab_yswi" if save_yswi else "ab"
    if residuals not in RESIDUAL_MODES:
        raise ValueError(f"unknown residual mode {residuals!r}; "
                         f"known: {RESIDUAL_MODES}")
    bk = get_backend(resolve(backend))
    d = dispatch
    if activation == "swiglu":
        if w2 is None:
            raise ValueError("the SwiGLU expert layer needs w2")
        if getattr(bk, "fused_moe", False):
            from repro_torch.kernels.ops import moe_ffn_blaze_fused
            return moe_ffn_blaze_fused(x, gates, d, w1, w3, w2)
        return _MoESwiGLU.apply(x, w1, w2, w3, gates, d.expert_token_indices,
                                d.token_index_map, d.expert_lengths,
                                residuals, bk)
    if activation not in _ACTS:
        raise ValueError(f"unknown activation {activation!r}; known: "
                         f"swiglu, {', '.join(_ACTS)}")
    if w2 is not None:
        raise ValueError(f"activation {activation!r} takes no w2")
    return _MoEMLP.apply(x, w1, w3, gates, d.expert_token_indices,
                         d.token_index_map, d.expert_lengths, activation,
                         residuals, bk)
