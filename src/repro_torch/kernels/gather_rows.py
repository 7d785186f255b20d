"""Row gather with zero rows (the ``ep_a2a`` send-buffer builder): CUDA
kernel and its plain version.

Replaces ``repro/kernels/gather_gmm.py:gather_rows_pallas`` (kernel
``_gather_rows_kernel``).  ``out[i] = src[row_ids[i]]``, with an exact
zero row where ``row_ids[i] < 0``; a pure copy, so the kernel and the
plain version agree bit for bit.

Bound on the card: bytes (each valid row read once, every output row
written once).  ``csrc/gather_rows.cu`` gives one warp to each output row
and moves it in 16-byte vectors; see the source for the design.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _lib


def gather_rows_plain(src: torch.Tensor,
                      row_ids: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: the reference's masked take
    (``models/moe_block.py:_a2a_gather_x``)."""
    ids = row_ids.long()
    rows = src[ids.clamp(min=0)]
    return torch.where((ids >= 0)[:, None], rows, rows.new_zeros(()))


def gather_rows(src: torch.Tensor, row_ids: torch.Tensor) -> torch.Tensor:
    """src: (L, d) float32 or bfloat16; row_ids: (N,) int32, each below L
    or negative -> (N, d) in ``src.dtype``.  A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel (counted in
    ``gather_rows.launches``; N = 0 launches nothing)."""
    if not src.is_cuda:
        return gather_rows_plain(src, row_ids)
    dt = src.dtype
    if dt not in _lib.DTYPE_CODE:
        raise ValueError(f"gather_rows takes float32 or bfloat16, got {dt}")
    _lib.require(src, "src", dtype=dt, ndim=2)
    _lib.require(row_ids, "row_ids", dtype=torch.int32, ndim=1,
                 device=src.device)
    L, d = src.shape
    N = row_ids.shape[0]
    out = torch.empty(N, d, dtype=dt, device=src.device)
    if N == 0 or d == 0:
        return out
    if _lib.dry("gather_rows", 0.0, (src, row_ids), (out,)):
        return out
    code = _lib.lib().repro_gather_rows(
        src.element_size(), src.data_ptr(), row_ids.data_ptr(),
        out.data_ptr(), N, L, d, _lib.stream_ptr(src))
    _lib.check("repro_gather_rows", code)
    gather_rows.launches += 1
    return out


gather_rows.launches = 0
