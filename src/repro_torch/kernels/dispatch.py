"""Dispatch-structure build: CUDA kernel and its plain version.

Replaces ``repro/kernels/dispatch.py:build_dispatch_pallas`` (kernels
``_count_kernel`` and ``_route_kernel``).  The kernel
(``csrc/dispatch.cu``) follows the paper's GPU pipeline instead of the
TPU's counter carried across in-order grid steps: per-warp expert counts by
ballots over contiguous runs of slots, shared-memory scans over warps and
experts, and a second walk that routes each slot.  It
returns integers bit-identical to the plain
:func:`repro_torch.core.routing.build_dispatch`.

:func:`dispatch_plan` picks the launches: up to :data:`N_ONE` slots one
launch (decode, prefill and training): one block up to
:data:`ONE_TILE_MIN` slots, else a thread-block cluster of at most
:data:`CLUSTER` blocks that exchange their counts through distributed
shared memory; past it, tiles of :data:`TILE` slots in two launches
(per-tile counts, then the build, launched as its programmatic dependent).

Bound: the launch (one, or a programmatic-dependent pair past N_ONE);
the call moves 12 bytes a slot.
"""

from __future__ import annotations

import torch

from repro_torch.core.routing import Dispatch, build_dispatch as build_dispatch_plain
from repro_torch.kernels import _lib

MAX_EXPERTS = 256
#: Most slots the one-launch build takes: one cluster of :data:`CLUSTER`
#: blocks.
N_ONE = 16384
#: Blocks of the one-launch build (a thread-block cluster; 8 is the
#: portable maximum).
CLUSTER = 8
#: Fewest slots a block of the one-launch build takes, unless all fit fewer.
ONE_TILE_MIN = 512
#: Slots a block takes past N_ONE.
TILE = 1024
#: Shared memory a launch gets without opting in (48 KB); every plan's
#: tile fits it (the source refuses more).
SMEM_DEFAULT = 48 * 1024


def _warps(tile: int) -> int:
    return min(32, max(1, -(-tile // 32)))


def _ceil32(x: int) -> int:
    return -(-x // 32) * 32


def dispatch_plan(n: int, num_experts: int) -> dict:
    """How ``csrc/dispatch.cu`` builds ``n`` slots over ``num_experts``:
    ``path`` ("one": one launch of one cluster of ``grid`` blocks; "two":
    per-tile counts, then the build), ``tile`` (slots a block takes: up to
    :data:`N_ONE` slots spread over the cluster, no fewer than
    :data:`ONE_TILE_MIN` a block; past it :data:`TILE`), ``grid`` (blocks
    a launch), ``threads`` (a block), ``launches``, ``scratch`` (int32
    elements of per-tile counts) and ``smem`` (bytes of shared memory a
    block; the source's ``smem_bytes``)."""
    E = num_experts
    tile = (max(32, _ceil32(-(-n // CLUSTER)), min(_ceil32(n), ONE_TILE_MIN))
            if n <= N_ONE else TILE)
    grid = max(1, -(-n // tile))
    one = grid <= CLUSTER
    W = _warps(tile)
    return {"path": "one" if one else "two", "tile": tile, "grid": grid,
            "threads": 32 * W, "launches": 1 if one else 2,
            "scratch": 0 if one else E * grid,
            "smem": 4 * (-(-tile // 4) * 4 + W * E + 4 * E + 1)}


def build_dispatch(topk_experts: torch.Tensor, num_experts: int) -> Dispatch:
    """(L, k) int32 top-k expert ids -> :class:`Dispatch`.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel (and counts the call in ``build_dispatch.launches``)."""
    if not topk_experts.is_cuda:
        return build_dispatch_plain(topk_experts, num_experts)
    E = num_experts
    if E > MAX_EXPERTS:
        raise ValueError(f"the dispatch kernel takes at most {MAX_EXPERTS} "
                         f"experts, got {E}")
    _lib.require(topk_experts, "topk_experts", dtype=torch.int32, ndim=2)
    L, k = topk_experts.shape
    n = L * k
    plan = dispatch_plan(n, E)
    i32 = dict(dtype=torch.int32, device=topk_experts.device)
    counts = torch.empty(plan["scratch"], **i32)
    lengths = torch.empty(E, **i32)
    offsets = torch.empty(E + 1, **i32)
    tim = torch.empty(n, **i32)
    eti = torch.empty(n, **i32)
    if not _lib.dry("build_dispatch", 0.0, (topk_experts,),
                    (lengths, offsets, tim, eti)):
        code = _lib.lib().repro_dispatch_build(
            topk_experts.data_ptr(), n, k, E, plan["tile"],
            counts.data_ptr(), lengths.data_ptr(), offsets.data_ptr(),
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

__all__ = ["build_dispatch", "build_dispatch_plain", "dispatch_plan"]
