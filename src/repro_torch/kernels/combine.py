"""Gather-of-partials combine: CUDA kernel and its plain version.

Replaces ``repro/kernels/combine.py:combine`` (kernel ``_combine_kernel``).
``y[l] = sum_i g[l, i] * p[tim[l, i]]`` with a float32 sum taken in the
order ``i = 0..k-1``, cast to ``p.dtype``.

Bound on the card: bytes (k partial rows read and one row written per
token).  ``csrc/combine.cu`` gives each token a warp, doubled while the
tokens fill less than half of the card (4 warps at Mixtral's prefill, a
block at decode), holds its slot ids and gates in registers and issues all
k rows' 16-byte loads before the sum; it rounds each product and sum as the
plain version does, so the two agree bit for bit.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _lib, cost


def combine_plain(p_out: torch.Tensor, token_index_map: torch.Tensor,
                  gates: torch.Tensor) -> torch.Tensor:
    L, k = token_index_map.shape
    tim = token_index_map.long()
    acc = torch.zeros(L, p_out.shape[1], dtype=torch.float32,
                      device=p_out.device)
    for i in range(k):
        acc = acc + gates[:, i, None].float() * p_out[tim[:, i]].float()
    return acc.to(p_out.dtype)


def combine(p_out: torch.Tensor, token_index_map: torch.Tensor,
            gates: torch.Tensor) -> torch.Tensor:
    """(S, d) partials + (L, k) int32 slot map + (L, k) gates -> (L, d).
    Gates must have ``p_out``'s dtype.  A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel (counted in
    ``combine.launches``)."""
    if not p_out.is_cuda:
        return combine_plain(p_out, token_index_map, gates)
    dt = p_out.dtype
    if dt not in _lib.DTYPE_CODE:
        raise ValueError(f"combine takes float32 or bfloat16, got {dt}")
    _lib.require(p_out, "p_out", dtype=dt, ndim=2)
    _lib.require(token_index_map, "token_index_map", dtype=torch.int32,
                 ndim=2, device=p_out.device)
    _lib.require(gates, "gates", dtype=dt, ndim=2, device=p_out.device)
    if gates.shape != token_index_map.shape:
        raise ValueError(f"gates {tuple(gates.shape)} != token_index_map "
                         f"{tuple(token_index_map.shape)}")
    L, k = token_index_map.shape
    d = p_out.shape[1]
    y = torch.empty(L, d, dtype=dt, device=p_out.device)
    if _lib.dry("combine", cost.combine(L, k, d),
                (p_out, token_index_map, gates), (y,)):
        return y
    code = _lib.lib().repro_combine(
        _lib.DTYPE_CODE[dt], p_out.data_ptr(), token_index_map.data_ptr(),
        gates.data_ptr(), y.data_ptr(), L, k, d, _lib.stream_ptr(p_out))
    _lib.check("repro_combine", code)
    combine.launches += 1
    return y


combine.launches = 0
