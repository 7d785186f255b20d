"""Gather-GMM: CUDA kernel and its plain version.

Replaces ``repro/kernels/gather_gmm.py:gather_gmm`` (kernel ``_kernel`` on
the ``make_work_items`` grid).  Grouped matmul over rows of the unpermuted
``x`` gathered through ``idx`` (``expert_token_indices``), expert ``e``
owning slot rows ``[offsets[e], offsets[e+1])``; with a second weight, the
dual branch and its ``silu(a) * b`` epilogue in float32, stored in
``x.dtype``; with ``save_ab`` also ``a`` and ``b`` in ``x.dtype`` (the
training residuals).  With ``trans_w`` a single weight stored
``(E, h, d)`` is used as its transpose, which is how the backward
multiplies by ``w1ᵀ``, ``w2ᵀ`` and ``w3ᵀ`` without a transposed copy.
Rows at or past ``offsets[E]`` are exact zeros.

Bound on the card: operations at prefill and in training, bytes (the
expert weights) at decode.  ``csrc/gather_gmm.cu`` tiles each expert's
slot rows by 128 and gives every output tile to one block of a
persistent, warp-specialized wgmma kernel (``csrc/moe_wgmma.cuh``, shared
with the fused MoE forward), so nothing is accumulated across blocks and
two calls give the same bits.  In bf16 with widths that are multiples of
8: the dual branch gathers its rows by 16-byte ``cp.async`` beside w1 and
w2 tiles brought by TMA; a single weight over identity rows (the w3
forward, the backward's transposed products) brings rows and weight by
TMA, a transposed weight read K-major, wgmma's own layout.  float32,
other widths and a single weight over gathered rows take a plain float32
tiled kernel.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _lib

MAX_EXPERTS = 256


def _silu(a: torch.Tensor) -> torch.Tensor:
    return a * torch.sigmoid(a)


def gather_gmm_plain(x: torch.Tensor, idx: torch.Tensor | None,
                     offsets: torch.Tensor, w1: torch.Tensor,
                     w2: torch.Tensor | None = None, *,
                     epilogue: bool = True, save_ab: bool = False,
                     trans_w: bool = False):
    """Plain PyTorch version (the ``kernels/ref.py`` semantics of the
    reference): gather, per-expert float32 matmul, epilogue in float32, one
    cast to ``x.dtype``."""
    _check_options(w2, epilogue, save_ab, trans_w)
    xg = x if idx is None else x[idx.long()]
    S = xg.shape[0]
    h = w1.shape[1] if trans_w else w1.shape[2]
    off = [int(v) for v in offsets.tolist()]
    y = torch.zeros(S, h, dtype=torch.float32, device=x.device)
    a_all = torch.zeros_like(y) if save_ab else None
    b_all = torch.zeros_like(y) if save_ab else None
    for e in range(w1.shape[0]):
        lo, hi = off[e], min(off[e + 1], S)
        if hi <= lo:
            continue
        xe = xg[lo:hi].float()
        a = xe @ (w1[e].float().T if trans_w else w1[e].float())
        if w2 is not None and epilogue:
            b = xe @ w2[e].float()
            if save_ab:
                a_all[lo:hi], b_all[lo:hi] = a, b
            a = _silu(a) * b
        y[lo:hi] = a
    if save_ab:
        return y.to(x.dtype), a_all.to(x.dtype), b_all.to(x.dtype)
    return y.to(x.dtype)


def _check_options(w2, epilogue: bool, save_ab: bool, trans_w: bool):
    if save_ab and (w2 is None or not epilogue):
        raise ValueError("save_ab needs the dual branch with its epilogue")
    if trans_w and w2 is not None:
        raise ValueError("trans_w takes a single weight")


def gather_gmm(x: torch.Tensor, idx: torch.Tensor | None,
               offsets: torch.Tensor, w1: torch.Tensor,
               w2: torch.Tensor | None = None, *, epilogue: bool = True,
               save_ab: bool = False, trans_w: bool = False):
    """x: (L, d); idx: (S,) int32 row ids, or ``None`` for identity rows
    (S = L); offsets: (E+1,) int32; w1, w2: (E, d, h), or with
    ``trans_w`` a single w1 stored (E, h, d).  Returns y (S, h) in
    ``x.dtype``, or ``(y, a, b)`` with ``save_ab``.  A CPU tensor takes the
    plain version; a CUDA tensor launches the kernel (counted in
    ``gather_gmm.launches``)."""
    if not x.is_cuda:
        return gather_gmm_plain(x, idx, offsets, w1, w2, epilogue=epilogue,
                                save_ab=save_ab, trans_w=trans_w)
    _check_options(w2, epilogue, save_ab, trans_w)
    dt = x.dtype
    if dt not in _lib.DTYPE_CODE:
        raise ValueError(f"gather_gmm takes float32 or bfloat16, got {dt}")
    _lib.require(x, "x", dtype=dt, ndim=2)
    _lib.require(w1, "w1", dtype=dt, ndim=3, device=x.device)
    _lib.require(offsets, "offsets", dtype=torch.int32, ndim=1,
                 device=x.device)
    L, d = x.shape
    if trans_w:
        E, h, dw = w1.shape
    else:
        E, dw, h = w1.shape
    if dw != d:
        raise ValueError(f"w1 is {tuple(w1.shape)} but x has d={d}")
    if E > MAX_EXPERTS or offsets.shape[0] != E + 1:
        raise ValueError(f"offsets must have E+1={E + 1} entries and E <= "
                         f"{MAX_EXPERTS}")
    if w2 is not None:
        _lib.require(w2, "w2", dtype=dt, ndim=3, device=x.device)
        if w2.shape != w1.shape:
            raise ValueError(f"w2 {tuple(w2.shape)} != w1 {tuple(w1.shape)}")
    if idx is not None:
        _lib.require(idx, "idx", dtype=torch.int32, ndim=1, device=x.device)
        S = idx.shape[0]
    else:
        S = L
    y = torch.empty(S, h, dtype=dt, device=x.device)
    a = torch.empty_like(y) if save_ab else None
    b = torch.empty_like(y) if save_ab else None
    ptr = lambda t: None if t is None else t.data_ptr()
    code = _lib.lib().repro_gather_gmm(
        _lib.DTYPE_CODE[dt], x.data_ptr(), ptr(idx), offsets.data_ptr(),
        w1.data_ptr(), ptr(w2), y.data_ptr(), ptr(a), ptr(b), S, L, d, h, E,
        int(w2 is not None), int(epilogue), int(trans_w), _lib.stream_ptr(x))
    _lib.check("repro_gather_gmm", code)
    gather_gmm.launches += 1
    return (y, a, b) if save_ab else y


gather_gmm.launches = 0
