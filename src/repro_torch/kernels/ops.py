"""The MoEBlaze expert layer composed from the kernels, with its
Algorithm-1 backward, and the layer as one fused kernel pair.

Mirrors ``repro/kernels/ops.py:moe_ffn_blaze_pallas`` (``_moe_pallas``):

- forward (``_moe_pallas_fwd``): gather-GMM with the dual SwiGLU epilogue,
  saving ``a`` and ``b``; the second grouped GEMM over identity rows
  (already in expert order); the gather-of-partials combine.  The routed
  ``(L*k, d)`` input never exists.
- backward (``_moe_pallas_bwd``): the slot gradients gathered through
  ``expert_token_indices``; ``dw3``, ``dw1`` and ``dw2`` by the grouped
  weight-gradient kernel; the products with ``w3ᵀ``, ``w1ᵀ`` and ``w2ᵀ``
  by gather-GMM on the transposed weights; SiLU recomputed from ``a``;
  the token gradient by a scatter-add over the index list.

The elementwise terms and the index operations are plain PyTorch, as the
reference computes them outside any Pallas kernel.  ``index_add_`` on the
card adds in no fixed order, but every token row receives k <= 2 addends
on a zero row, and a sum of two floating-point numbers commutes exactly,
so the result does not depend on the order.

``moe_ffn_blaze_fused`` mirrors ``moe_ffn_blaze_fused`` (``_moe_fused``):
the fused forward and backward kernels of ``kernels/fused_moe.py``; the
residuals are the inputs and the ``(S,)`` float32 slot gates only.

``gather_rows`` mirrors ``gather_rows`` (``ops.py:213-233``): the forward
is the row-gather kernel, the backward the reference's
``_gather_rows_bwd``, computed outside any kernel as the reference does:
the rows with a non-negative id are scatter-added into a zero ``(L, d)``
in ``src.dtype`` by ``index_add_``, whose order of additions on the card
is not fixed (exact for a row gathered at most twice).

``swiglu`` mirrors the dense ``swiglu`` custom VJP (``ops.py:42-60``):
forward ``fused_swiglu_fwd``, saving only ``x``, ``w1``, ``w2``, ``a`` and
``b`` (the paper's policy: save A and B, recompute SiLU; ``y`` is never
saved); backward ``fused_swiglu_bwd_x`` for dx and ``fused_swiglu_bwd_w``
for dw1 and dw2, returned in ``x.dtype`` as the reference returns them
(autograd carries them to float32 masters through the cast).
"""

from __future__ import annotations

import torch

from repro_torch.core.routing import Dispatch
from repro_torch.kernels.combine import combine
from repro_torch.kernels.fused_moe import fused_moe_bwd, fused_moe_fwd
from repro_torch.kernels.fused_swiglu import (fused_swiglu_bwd_w,
                                              fused_swiglu_bwd_x,
                                              fused_swiglu_fwd)
from repro_torch.kernels.gather_gmm import gather_gmm
from repro_torch.kernels.gather_rows import gather_rows as _gather_rows
from repro_torch.kernels.gmm_dw import gmm_dw


class MoEBlazePallas(torch.autograd.Function):
    """y = combine(gather_gmm(gather_gmm(x, w1, w2), w3), gates) with the
    residuals ``a``, ``b`` and ``y_swi`` (the reference's fixed set)."""

    @staticmethod
    def forward(ctx, x, gates, w1, w2, w3, eti, off, tim):
        y_swi, a, b = gather_gmm(x, eti, off, w1, w2, save_ab=True)
        p_out = gather_gmm(y_swi, None, off, w3, epilogue=False)
        ctx.save_for_backward(x, w1, w2, w3, gates, eti, off, tim, a, b,
                              y_swi)
        return combine(p_out, tim, gates)

    @staticmethod
    def backward(ctx, dy):
        x, w1, w2, w3, gates, eti, off, tim, a, b, y_swi = ctx.saved_tensors
        eti_l, tim_l = eti.long(), tim.reshape(-1).long()
        g_slot = torch.zeros(eti.shape[0], dtype=gates.dtype,
                             device=gates.device)
        g_slot[tim_l] = gates.reshape(-1)
        g_col = g_slot[:, None].to(y_swi.dtype)
        # slot gradients, gathered through the index metadata
        dyg = dy.to(x.dtype)[eti_l]
        dw3 = gmm_dw(y_swi * g_col, dyg, off)
        dyu = gather_gmm(dyg, None, off, w3, epilogue=False, trans_w=True)
        dgates = (y_swi * dyu).sum(-1)[tim_l].reshape(gates.shape)
        dy_swi = dyu * g_col
        # SwiGLU backward with SiLU recomputed
        sa = torch.sigmoid(a)
        da = dy_swi * b * (sa * (1.0 + a * (1.0 - sa)))
        db = dy_swi * (a * sa)
        xg = x[eti_l]
        dw1 = gmm_dw(xg, da, off)
        dw2 = gmm_dw(xg, db, off)
        dxg = (gather_gmm(da, None, off, w1, epilogue=False, trans_w=True)
               + gather_gmm(db, None, off, w2, epilogue=False, trans_w=True))
        dx = torch.zeros_like(x).index_add_(0, eti_l, dxg.to(x.dtype))
        return (dx, dgates.to(gates.dtype), dw1, dw2, dw3, None, None, None)


def moe_ffn_blaze_pallas(x: torch.Tensor, gates: torch.Tensor,
                         dispatch: Dispatch, w1: torch.Tensor,
                         w3: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """SwiGLU expert layer: x (L, d), gates (L, k), w1/w2 (E, d, h),
    w3 (E, h, d) -> (L, d) in ``x.dtype``; differentiable in x, gates and
    the weights."""
    d = dispatch
    return MoEBlazePallas.apply(x, gates.to(x.dtype).contiguous(), w1, w2,
                                w3, d.expert_token_indices,
                                d.expert_token_offsets, d.token_index_map)


class MoEBlazeFused(torch.autograd.Function):
    """y = fused_moe_fwd(...) cast to ``x.dtype``; the backward is
    fused_moe_bwd, which replays the gather and recomputes a, b and SiLU,
    so nothing of size (S, h) or (S, d) is saved."""

    @staticmethod
    def forward(ctx, x, gates, w1, w2, w3, eti, off, tim):
        g_slot = torch.zeros(eti.shape[0], dtype=torch.float32,
                             device=x.device)
        g_slot[tim.reshape(-1).long()] = gates.reshape(-1).float()
        y = fused_moe_fwd(x, g_slot, eti, off, w1, w2, w3)
        ctx.save_for_backward(x, w1, w2, w3, eti, off, tim, g_slot)
        ctx.gates_dtype = gates.dtype
        return y.to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        x, w1, w2, w3, eti, off, tim, g_slot = ctx.saved_tensors
        dx, dgs, dw1, dw2, dw3 = fused_moe_bwd(
            x, dy.to(x.dtype).contiguous(), g_slot, eti, off, w1, w2, w3)
        dgates = dgs[tim.reshape(-1).long()].reshape(tim.shape)
        return (dx.to(x.dtype), dgates.to(ctx.gates_dtype), dw1.to(w1.dtype),
                dw2.to(w2.dtype), dw3.to(w3.dtype), None, None, None)


def moe_ffn_blaze_fused(x: torch.Tensor, gates: torch.Tensor,
                        dispatch: Dispatch, w1: torch.Tensor,
                        w3: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """SwiGLU expert layer as one fused kernel pair: x (L, d), gates
    (L, k), w1/w2 (E, d, h), w3 (E, h, d) -> (L, d) in ``x.dtype``;
    differentiable in x, gates and the weights."""
    d = dispatch
    return MoEBlazeFused.apply(x.contiguous(), gates, w1, w2, w3,
                               d.expert_token_indices,
                               d.expert_token_offsets, d.token_index_map)


class SwiGLU(torch.autograd.Function):
    """y = silu(x w1) (x w2) through the fused forward kernel; the
    residuals are the inputs and the kernel's a and b."""

    @staticmethod
    def forward(ctx, x, w1, w2):
        y, a, b = fused_swiglu_fwd(x, w1, w2)
        ctx.save_for_backward(x, w1, w2, a, b)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w1, w2, a, b = ctx.saved_tensors
        dy = dy.to(x.dtype).contiguous()
        dx = fused_swiglu_bwd_x(dy, a, b, w1, w2)
        dw1, dw2 = fused_swiglu_bwd_w(x, dy, a, b)
        return dx, dw1, dw2


def swiglu(x: torch.Tensor, w1: torch.Tensor,
           w2: torch.Tensor) -> torch.Tensor:
    """Dense fused SwiGLU: x (L, d), w1/w2 (d, h) -> (L, h) in
    ``x.dtype``; differentiable in x and the weights."""
    return SwiGLU.apply(x.contiguous(), w1.contiguous(), w2.contiguous())


class GatherRows(torch.autograd.Function):
    """out[i] = src[row_ids[i]], zero rows for negative ids; the backward
    scatter-adds the valid rows' gradients back."""

    @staticmethod
    def forward(ctx, src, row_ids):
        ctx.save_for_backward(row_ids)
        ctx.src_shape = src.shape
        return _gather_rows(src, row_ids)

    @staticmethod
    def backward(ctx, dout):
        (row_ids,) = ctx.saved_tensors
        valid = (row_ids >= 0)[:, None]
        contrib = torch.where(valid, dout, dout.new_zeros(()))
        dsrc = dout.new_zeros(ctx.src_shape).index_add_(
            0, row_ids.long().clamp(min=0), contrib)
        return dsrc, None


def gather_rows(src: torch.Tensor, row_ids: torch.Tensor) -> torch.Tensor:
    """Differentiable row gather: src (L, d), row_ids (N,) int32 -> (N, d)
    in ``src.dtype``; a negative id gives a zero row."""
    return GatherRows.apply(src.contiguous(),
                            row_ids.to(torch.int32).contiguous())
