"""Grouped weight gradient: CUDA kernel and its plain version.

Replaces ``repro/kernels/gather_gmm.py:gmm_dw_pallas`` (kernel
``_dw_kernel``).  For rows already in expert order, expert ``e`` owning
rows ``[offsets[e], offsets[e+1])``:

    dw[e] = lhs[rows_e]^T @ dout[rows_e]        (E, d, h)

summed in float32 and cast once to ``lhs.dtype``; experts with no rows get
exact zeros, and rows at or past ``offsets[E]`` (the pad and overflow
rows of an expert-parallel rank's layout) contribute nothing.  In the
training step's backward it gives ``dw1``, ``dw2`` (``lhs`` = the
re-gathered input, ``dout`` = ``da`` / ``db``) and ``dw3`` (``lhs`` = the
gated ``y_swi``, ``dout`` = the slot gradients).

Bound on the card: operations (2·S·d·h; at S = 8192 slots, d = 4096,
h = 14336 it is ~0.96 TFLOP against ~0.6 GB of inputs and outputs).
``csrc/gmm_dw.cu`` runs the bf16 case on ``csrc/moe_wgmma.cuh``'s
``moe_dw_wgmma`` (wgmma + TMA, persistent; shared with the fused MoE
backward): each output tile has one block, which walks the expert's row
range itself, so nothing is accumulated across blocks and a repeated
call gives the same bits; see the sources for the design.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.gather_gmm import MAX_EXPERTS


def gmm_dw_plain(lhs: torch.Tensor, dout: torch.Tensor,
                 offsets: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: per-expert float32 product, one cast."""
    S, d = lhs.shape
    h = dout.shape[1]
    E = offsets.shape[0] - 1
    off = [int(v) for v in offsets.tolist()]
    dw = torch.zeros(E, d, h, dtype=torch.float32, device=lhs.device)
    for e in range(E):
        lo, hi = off[e], min(off[e + 1], S)
        if hi > lo:
            dw[e] = lhs[lo:hi].float().T @ dout[lo:hi].float()
    return dw.to(lhs.dtype)


def gmm_dw(lhs: torch.Tensor, dout: torch.Tensor,
           offsets: torch.Tensor) -> torch.Tensor:
    """lhs: (S, d); dout: (S, h); offsets: (E+1,) int32.  Returns
    (E, d, h) in ``lhs.dtype``.  A CPU tensor takes the plain version; a
    CUDA tensor launches the kernel (counted in ``gmm_dw.launches``)."""
    if not lhs.is_cuda:
        return gmm_dw_plain(lhs, dout, offsets)
    dt = lhs.dtype
    if dt not in _lib.DTYPE_CODE:
        raise ValueError(f"gmm_dw takes float32 or bfloat16, got {dt}")
    _lib.require(lhs, "lhs", dtype=dt, ndim=2)
    _lib.require(dout, "dout", dtype=dt, ndim=2, device=lhs.device)
    _lib.require(offsets, "offsets", dtype=torch.int32, ndim=1,
                 device=lhs.device)
    S, d = lhs.shape
    if dout.shape[0] != S:
        raise ValueError(f"dout has {dout.shape[0]} rows, lhs has {S}")
    h = dout.shape[1]
    E = offsets.shape[0] - 1
    if not 1 <= E <= MAX_EXPERTS:
        raise ValueError(f"offsets must have 2..{MAX_EXPERTS + 1} entries")
    dw = torch.empty(E, d, h, dtype=dt, device=lhs.device)
    code = _lib.lib().repro_gmm_dw(
        _lib.DTYPE_CODE[dt], lhs.data_ptr(), dout.data_ptr(),
        offsets.data_ptr(), dw.data_ptr(), S, d, h, E, _lib.stream_ptr(lhs))
    _lib.check("repro_gmm_dw", code)
    gmm_dw.launches += 1
    return dw


gmm_dw.launches = 0
