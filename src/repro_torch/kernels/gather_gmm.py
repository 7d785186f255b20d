"""Gather-GMM: CUDA kernel and its plain version.

Replaces ``repro/kernels/gather_gmm.py:gather_gmm`` (kernel ``_kernel`` on
the ``make_work_items`` grid).  Grouped matmul over rows of the unpermuted
``x`` gathered through ``idx`` (``expert_token_indices``), expert ``e``
owning slot rows ``[offsets[e], offsets[e+1])``; with a second weight, the
dual branch and its ``silu(a) * b`` epilogue in float32, stored in
``x.dtype``.  Rows at or past ``offsets[E]`` are exact zeros.

Bound on the card: operations at prefill, bytes (the expert weights) at
decode.  ``csrc/gather_gmm.cu`` owns one output tile per block and loops
over the experts overlapping it (no cross-block accumulation), gathers the
A tile with 16-byte ``cp.async`` copies, and runs bf16 WMMA with float32
accumulators; float32 inputs and widths that are not a multiple of 8 take a
plain float32 tiled kernel.
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
                     epilogue: bool = True) -> torch.Tensor:
    """Plain PyTorch version (the ``kernels/ref.py`` semantics of the
    reference): gather, per-expert float32 matmul, epilogue in float32, one
    cast to ``x.dtype``."""
    xg = x if idx is None else x[idx.long()]
    S = xg.shape[0]
    h = w1.shape[2]
    off = [int(v) for v in offsets.tolist()]
    y = torch.zeros(S, h, dtype=torch.float32, device=x.device)
    for e in range(w1.shape[0]):
        lo, hi = off[e], min(off[e + 1], S)
        if hi <= lo:
            continue
        xe = xg[lo:hi].float()
        a = xe @ w1[e].float()
        if w2 is not None and epilogue:
            a = _silu(a) * (xe @ w2[e].float())
        y[lo:hi] = a
    return y.to(x.dtype)


def gather_gmm(x: torch.Tensor, idx: torch.Tensor | None,
               offsets: torch.Tensor, w1: torch.Tensor,
               w2: torch.Tensor | None = None, *,
               epilogue: bool = True) -> torch.Tensor:
    """x: (L, d); idx: (S,) int32 row ids, or ``None`` for identity rows
    (S = L); offsets: (E+1,) int32; w1, w2: (E, d, h).  Returns (S, h) in
    ``x.dtype``.  A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel (counted in ``gather_gmm.launches``)."""
    if not x.is_cuda:
        return gather_gmm_plain(x, idx, offsets, w1, w2, epilogue=epilogue)
    dt = x.dtype
    if dt not in _lib.DTYPE_CODE:
        raise ValueError(f"gather_gmm takes float32 or bfloat16, got {dt}")
    _lib.require(x, "x", dtype=dt, ndim=2)
    _lib.require(w1, "w1", dtype=dt, ndim=3, device=x.device)
    _lib.require(offsets, "offsets", dtype=torch.int32, ndim=1,
                 device=x.device)
    L, d = x.shape
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
    code = _lib.lib().repro_gather_gmm(
        _lib.DTYPE_CODE[dt], x.data_ptr(),
        None if idx is None else idx.data_ptr(), offsets.data_ptr(),
        w1.data_ptr(), None if w2 is None else w2.data_ptr(), y.data_ptr(),
        S, L, d, h, E, int(w2 is not None), int(epilogue),
        _lib.stream_ptr(x))
    _lib.check("repro_gather_gmm", code)
    gather_gmm.launches += 1
    return y


gather_gmm.launches = 0
