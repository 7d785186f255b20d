"""Dispatch-structure build: CUDA kernel and its plain version.

Replaces ``repro/kernels/dispatch.py:build_dispatch_pallas`` (kernels
``_count_kernel`` and ``_route_kernel``).  The kernel
(``csrc/dispatch.cu``) runs the paper's three atomic-free steps (per-block
counts, one scan, per-block ranks in slot order) instead of the TPU's
counter carried across in-order grid steps, and returns integers
bit-identical to the plain :func:`repro_torch.core.routing.build_dispatch`.

Bound: launch latency; the call moves a few KB of int32.
"""

from __future__ import annotations

import torch

from repro_torch.core.routing import Dispatch, build_dispatch as build_dispatch_plain
from repro_torch.kernels import _lib

MAX_EXPERTS = 256
CHUNK = 256   # slots per block (csrc/dispatch.cu)


def build_dispatch(topk_experts: torch.Tensor, num_experts: int) -> Dispatch:
    """(L, k) int32 top-k expert ids -> :class:`Dispatch`.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel (and counts the launch in ``build_dispatch.launches``)."""
    if not topk_experts.is_cuda:
        return build_dispatch_plain(topk_experts, num_experts)
    if num_experts > MAX_EXPERTS:
        raise ValueError(f"the dispatch kernel takes at most {MAX_EXPERTS} "
                         f"experts, got {num_experts}")
    _lib.require(topk_experts, "topk_experts", dtype=torch.int32, ndim=2)
    L, k = topk_experts.shape
    n = L * k
    E = num_experts
    dev = topk_experts.device
    nb = -(-n // CHUNK)
    i32 = dict(dtype=torch.int32, device=dev)
    block_counts = torch.empty(max(nb, 1) * E, **i32)
    block_base = torch.empty(max(nb, 1) * E, **i32)
    lengths = torch.empty(E, **i32)
    offsets = torch.empty(E + 1, **i32)
    tim = torch.empty(n, **i32)
    eti = torch.empty(n, **i32)
    lib = _lib.lib()
    code = lib.repro_dispatch_build(
        topk_experts.data_ptr(), n, k, E, block_counts.data_ptr(),
        block_base.data_ptr(), lengths.data_ptr(), offsets.data_ptr(),
        tim.data_ptr(), eti.data_ptr(), _lib.stream_ptr(topk_experts))
    _lib.check("repro_dispatch_build", code)
    build_dispatch.launches += 1
    return Dispatch(
        expert_token_indices=eti,
        expert_token_offsets=offsets,
        token_expert_indices=topk_experts.reshape(n),
        token_index_map=tim.reshape(L, k),
        expert_lengths=lengths,
    )


build_dispatch.launches = 0

__all__ = ["build_dispatch", "build_dispatch_plain"]
