"""Fused dispatch→GEMM→combine SwiGLU MoE forward and backward: CUDA
kernels and their plain versions.

Replace ``repro/kernels/gather_gmm.py:fused_moe_fwd`` and
``fused_moe_bwd``.  The whole expert layer in one call per direction: the
gather of token rows, both first-layer GEMMs, SiLU·gate, the second GEMM
and the gated scatter-combine; the backward replays the gather and
recomputes a, b and SiLU.  Neither direction writes an ``(S, h)`` or
``(S, d)`` buffer (S = L·k slots) whole: both walk h in ranges and keep a
bounded workspace of the range's columns.

The bf16 forward walks h in ranges of width ``hc`` (:func:`pass_width`):
per range one kernel writes the rounded ``y_swi`` of those columns into a
bf16 ``(S, hc)`` chunk, capped at :data:`CHUNK_CAP_BYTES` (32 MiB, a
fixed bound on the workspace whatever S; ``tools/fused_moe_ranges.py``
times the forward per width), and a second adds the chunk's gated
products into each slot's row of a float32 ``(S, d)`` buffer; a last
kernel sums each token's slot rows into y in the order of its entries in
the dispatch's ``token_index_map``.  A call is
2·⌈h/hc⌉ + 1 kernel launches (15 at Mixtral's training shape, 3 at
decode) and counts once in ``fused_moe_fwd.launches``.

The bf16 backward walks h in ranges of width :func:`bwd_pass_width`:
three bf16 ``(S, hc)`` chunks (``da``, ``db`` and ``g·y_swi`` of the
range, each rounded once) within :data:`BWD_CHUNK_CAP_BYTES` (64 MiB),
and a float32 ``(⌈h/128⌉, S)`` buffer of dgates partials.  Per range four
kernels: the recomputed a, b and dyu with the elementwise terms, the dw1
and dw2 columns of the range, dw3's rows of the range, and each slot's
row of dx into a float32 ``(S, d)`` buffer; then one sum of the dgates
partials and one fixed-order sum of each token's slot rows into dx
(:func:`fused_moe_bwd_passes_plain` is the same decomposition in plain
PyTorch).  A call is 4·⌈h/hc⌉ + 2 kernel launches (50 at Mixtral's
training shape, 6 at decode) and counts once in
``fused_moe_bwd.launches``.

Rounding points (the reference's, kept by the plain versions): ``y_swi``
is rounded to the I/O dtype before the second GEMM and in the backward;
``dyu`` is rounded to the I/O dtype; everything else is float32, and the
outputs are float32 (the caller casts).  The bf16 backward also rounds
``da``, ``db`` and ``g·y_swi`` to bf16, the tensor cores' operands.

The general path (float32, or bf16 with d or h not a multiple of 8, or a
tensor off 16-byte alignment: :func:`tensor_core_path` says which) walks
the same h-ranges through float32 chunks (:func:`general_pass_width`,
:func:`general_bwd_pass_width`: ``y_swi``, or da, db and g·y_swi, as
float32 values, ``y_swi`` rounded to the I/O dtype first) with float32-FMA
kernels, da and db kept in float32; its dgates partials are per 32-column
tile, a float32 ``(⌈h/32⌉, S)`` buffer.

Bound on the card: operations (6·S·d·h forward, 16·S·d·h backward) in
training, the touched experts' weight bytes at decode (and the backward's
float32 weight gradients).  ``csrc/fused_moe_fwd.cu`` and
``csrc/fused_moe_bwd.cu`` (wgmma + TMA, the kernels of
``csrc/moe_wgmma.cuh``, and the float32-FMA kernels of the general path)
give every element of every output one writer on both paths, so a
repeated call gives the same bits.  See the sources for the designs.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _lib, cost
from repro_torch.kernels.gather_gmm import MAX_EXPERTS, _silu


#: Bytes the bf16 forward's ``(S, hc)`` y_swi chunk may take.
CHUNK_CAP_BYTES = 32 * 2 ** 20
#: Columns of h per tile of the forward's first kernel; ``hc`` is a
#: multiple of it.
H_TILE = 128


def pass_width(S: int, h: int) -> int:
    """Width ``hc`` of the forward's h-ranges: the largest multiple of
    :data:`H_TILE` whose bf16 ``(S, hc)`` chunk fits
    :data:`CHUNK_CAP_BYTES`, and no wider than h rounded up to the tile
    (one range).  Never below one tile: above 131,072 slots the chunk is
    ``S · H_TILE`` values."""
    return _width(CHUNK_CAP_BYTES, 2, S, h)


def _width(cap: int, slot_bytes: int, S: int, h: int) -> int:
    """The largest multiple of :data:`H_TILE` whose ``slot_bytes`` per
    slot and column fit ``cap`` at S slots, no wider than h rounded up to
    the tile, never below one tile."""
    hc = cap // (max(S, 1) * slot_bytes) // H_TILE * H_TILE
    return min(max(hc, H_TILE), -(-h // H_TILE) * H_TILE)


#: Bytes the bf16 backward's three ``(S, hc)`` chunks (da, db, g·y_swi)
#: may take together.
BWD_CHUNK_CAP_BYTES = 64 * 2 ** 20


def bwd_pass_width(S: int, h: int) -> int:
    """Width ``hc`` of the backward's h-ranges: the largest multiple of
    :data:`H_TILE` whose three bf16 ``(S, hc)`` chunks fit
    :data:`BWD_CHUNK_CAP_BYTES`, no wider than h rounded up to the tile,
    never below one tile (1280 at S = 8192: 60 MiB)."""
    return _width(BWD_CHUNK_CAP_BYTES, 6, S, h)


def general_pass_width(S: int, h: int) -> int:
    """Width ``hc`` of the general forward's h-ranges: its float32
    ``(S, hc)`` chunk within :data:`CHUNK_CAP_BYTES`, as
    :func:`pass_width` (one range up to 4096 columns at 2048 slots)."""
    return _width(CHUNK_CAP_BYTES, 4, S, h)


def general_bwd_pass_width(S: int, h: int) -> int:
    """Width ``hc`` of the general backward's h-ranges: its three float32
    ``(S, hc)`` chunks within :data:`BWD_CHUNK_CAP_BYTES`, as
    :func:`bwd_pass_width` (one range up to 2688 columns at 2048 slots)."""
    return _width(BWD_CHUNK_CAP_BYTES, 12, S, h)


#: Columns of h per dgates partial on the general path.
GENERAL_H_TILE = 32


def tensor_core_path(x: torch.Tensor, ws, dy=None) -> bool:
    """Whether the kernels take the tensor-core path for these inputs
    (bf16, d and h multiples of 8, x, dy and the weights ``ws`` 16-byte
    aligned) rather than the general one.  The one place the path is
    chosen: :func:`fused_moe_fwd` and :func:`fused_moe_bwd` size the
    workspace for it and pass it to ``csrc/fused_moe_fwd.cu`` and
    ``csrc/fused_moe_bwd.cu``, which refuse the tensor-core path for
    inputs it cannot take."""
    d, h = x.shape[1], ws[0].shape[2]
    ts = (x, *ws) if dy is None else (x, dy, *ws)
    return (x.dtype == torch.bfloat16 and d % 8 == 0 and h % 8 == 0
            and all(_lib.aligned16(t) for t in ts))


def h_ranges(h: int, hc: int) -> list[tuple[int, int]]:
    """The h-ranges ``(h0, width)`` for a range width ``hc``
    (:func:`pass_width`, :func:`bwd_pass_width`): consecutive, covering
    ``[0, h)``, each ``hc`` wide but the last, as ``csrc/fused_moe_fwd.cu``
    and ``csrc/fused_moe_bwd.cu`` walk them."""
    return [(h0, min(hc, h - h0)) for h0 in range(0, h, hc)]


def _dsilu(a: torch.Tensor) -> torch.Tensor:
    s = torch.sigmoid(a)
    return s * (1.0 + a * (1.0 - s))


def _round(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return t.to(dtype).float()


def _expert_rows(offsets: torch.Tensor, S: int):
    off = [int(v) for v in offsets.tolist()]
    for e in range(len(off) - 1):
        lo, hi = min(off[e], S), min(off[e + 1], S)
        if hi > lo:
            yield e, lo, hi


def fused_moe_fwd_plain(x, g_slot, idx, offsets, w1, w2, w3) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_moe_fwd`."""
    S = idx.shape[0]
    y = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for e, lo, hi in _expert_rows(offsets, S):
        rows = idx[lo:hi].long()
        xe = x[rows].float()
        a = xe @ w1[e].float()
        b = xe @ w2[e].float()
        y_swi = _round(_silu(a) * b, x.dtype)
        y.index_add_(0, rows, g_slot[lo:hi, None] * (y_swi @ w3[e].float()))
    return y


def fused_moe_fwd_passes_plain(x, g_slot, idx, offsets, w1, w2, w3, *,
                               hc: int) -> torch.Tensor:
    """The bf16 kernel's decomposition in plain PyTorch: for each h-range
    of :func:`h_ranges`, the ``(S, width)`` chunk of ``y_swi`` rounded to
    x's dtype, then its gated products added into y.  The same function
    as :func:`fused_moe_fwd_plain`, with the second product's float32 sum
    split at the range boundaries."""
    S, h = idx.shape[0], w1.shape[2]
    y = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    experts = [(e, lo, hi, idx[lo:hi].long())
               for e, lo, hi in _expert_rows(offsets, S)]
    for h0, width in h_ranges(h, hc):
        cols = slice(h0, h0 + width)
        chunk = torch.zeros(S, width, dtype=x.dtype, device=x.device)
        for e, lo, hi, rows in experts:
            xe = x[rows].float()
            chunk[lo:hi] = _round(_silu(xe @ w1[e][:, cols].float())
                                  * (xe @ w2[e][:, cols].float()), x.dtype)
        for e, lo, hi, rows in experts:
            y.index_add_(0, rows, g_slot[lo:hi, None]
                         * (chunk[lo:hi].float() @ w3[e][cols].float()))
    return y


def fused_moe_bwd_plain(x, dy, g_slot, idx, offsets, w1, w2, w3):
    """Plain PyTorch version of :func:`fused_moe_bwd`."""
    S = idx.shape[0]
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.zeros(x.shape, **f32)
    dg = torch.zeros(S, **f32)
    dw1 = torch.zeros(w1.shape, **f32)
    dw2 = torch.zeros(w2.shape, **f32)
    dw3 = torch.zeros(w3.shape, **f32)
    for e, lo, hi in _expert_rows(offsets, S):
        rows = idx[lo:hi].long()
        xe, dye = x[rows].float(), dy[rows].float()
        w1e, w2e, w3e = w1[e].float(), w2[e].float(), w3[e].float()
        a, b = xe @ w1e, xe @ w2e
        sa = _silu(a)
        y_swi = _round(sa * b, x.dtype)
        dyu = _round(dye @ w3e.T, x.dtype)
        g = g_slot[lo:hi, None]
        dy_swi = dyu * g
        da = dy_swi * b * _dsilu(a)
        db = dy_swi * sa
        dg[lo:hi] = (y_swi * dyu).sum(-1)
        dw1[e] = xe.T @ da
        dw2[e] = xe.T @ db
        dw3[e] = (y_swi * g).T @ dye
        dx.index_add_(0, rows, da @ w1e.T + db @ w2e.T)
    return dx, dg, dw1, dw2, dw3


def fused_moe_bwd_passes_plain(x, dy, g_slot, idx, offsets, w1, w2, w3, *,
                               hc: int):
    """The bf16 backward's decomposition in plain PyTorch: for each h-range
    of :func:`h_ranges`, da, db and g·y_swi of the range rounded to x's
    dtype (the kernels' tensor-core operands), then the range's columns of
    dw1 and dw2, its rows of dw3, its products added into dx and its
    dgates partial; the partials summed in range order.  The same function
    as :func:`fused_moe_bwd_plain` with the float32 sums over h split at
    the range boundaries."""
    S, h = idx.shape[0], w1.shape[2]
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.zeros(x.shape, **f32)
    dg = torch.zeros(S, **f32)
    dw1 = torch.zeros(w1.shape, **f32)
    dw2 = torch.zeros(w2.shape, **f32)
    dw3 = torch.zeros(w3.shape, **f32)
    experts = [(e, lo, hi, idx[lo:hi].long())
               for e, lo, hi in _expert_rows(offsets, S)]
    for h0, width in h_ranges(h, hc):
        cols = slice(h0, h0 + width)
        for e, lo, hi, rows in experts:
            xe, dye = x[rows].float(), dy[rows].float()
            a = xe @ w1[e][:, cols].float()
            b = xe @ w2[e][:, cols].float()
            sa = _silu(a)
            y_swi = _round(sa * b, x.dtype)
            dyu = _round(dye @ w3[e][cols].float().T, x.dtype)
            g = g_slot[lo:hi, None]
            da = _round(dyu * g * b * _dsilu(a), x.dtype)
            db = _round(dyu * g * sa, x.dtype)
            dg[lo:hi] += (y_swi * dyu).sum(-1)
            dw1[e][:, cols] = xe.T @ da
            dw2[e][:, cols] = xe.T @ db
            dw3[e][cols] = _round(y_swi * g, x.dtype).T @ dye
            dx.index_add_(0, rows, da @ w1[e][:, cols].float().T
                          + db @ w2[e][:, cols].float().T)
    return dx, dg, dw1, dw2, dw3


def _check(x, g_slot, idx, offsets, w1, w2, w3, dy=None):
    """Checks of what the kernels take; returns (S, L, d, h, E)."""
    dt = x.dtype
    if dt not in _lib.DTYPE_CODE:
        raise ValueError(f"the fused MoE kernels take float32 or bfloat16, "
                         f"got {dt}")
    dev = x.device
    _lib.require(x, "x", dtype=dt, ndim=2)
    if dy is not None:
        _lib.require(dy, "dy", dtype=dt, ndim=2, device=dev)
        if dy.shape != x.shape:
            raise ValueError(f"dy {tuple(dy.shape)} != x {tuple(x.shape)}")
    _lib.require(g_slot, "g_slot", dtype=torch.float32, ndim=1, device=dev)
    _lib.require(idx, "idx", dtype=torch.int32, ndim=1, device=dev)
    _lib.require(offsets, "offsets", dtype=torch.int32, ndim=1, device=dev)
    for name, w in (("w1", w1), ("w2", w2), ("w3", w3)):
        _lib.require(w, name, dtype=dt, ndim=3, device=dev)
    L, d = x.shape
    E, dw, h = w1.shape
    S = idx.shape[0]
    if dw != d or w2.shape != w1.shape or tuple(w3.shape) != (E, h, d):
        raise ValueError(f"weights w1 {tuple(w1.shape)}, w2 "
                         f"{tuple(w2.shape)}, w3 {tuple(w3.shape)} do not "
                         f"fit x (L, d) = {tuple(x.shape)}")
    if g_slot.shape[0] != S:
        raise ValueError(f"g_slot has {g_slot.shape[0]} slots, idx has {S}")
    if not 1 <= E <= MAX_EXPERTS or offsets.shape[0] != E + 1:
        raise ValueError(f"offsets must have E+1={E + 1} entries and E <= "
                         f"{MAX_EXPERTS}")
    return S, L, d, h, E


def _check_tim(tim, idx, L: int) -> None:
    """The dispatch's ``(L, k)`` int32 ``token_index_map``: the order in
    which the kernels sum each token's per-slot rows."""
    if tim is None:
        raise ValueError("the fused MoE kernels take the dispatch's "
                         "token_index_map (tim) on the card")
    _lib.require(tim, "token_index_map", dtype=torch.int32, ndim=2,
                 device=idx.device)
    if tim.shape[0] != L:
        raise ValueError(f"token_index_map has {tim.shape[0]} rows for "
                         f"L={L} tokens")


def fused_moe_fwd(x: torch.Tensor, g_slot: torch.Tensor, idx: torch.Tensor,
                  offsets: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
                  w3: torch.Tensor,
                  tim: torch.Tensor | None = None) -> torch.Tensor:
    """x: (L, d); g_slot: (S,) float32 slot gates in expert order; idx:
    (S,) int32 ``expert_token_indices``; offsets: (E+1,) int32; w1, w2:
    (E, d, h); w3: (E, h, d); ``tim``: the dispatch's (L, k) int32
    ``token_index_map``, the order of each token's slots in its sum (the
    plain version, which adds slots by ``index_add_``, takes none).
    Returns the combined (L, d) output in float32.  A CPU tensor takes the
    plain version; a CUDA tensor launches the kernels (counted once per
    call in ``fused_moe_fwd.launches``).  The call allocates one
    ``(S, hc)`` workspace of at most :data:`CHUNK_CAP_BYTES` (bf16 on the
    tensor-core path, :func:`pass_width`; float32 on the general one,
    :func:`general_pass_width`; ``S · 128`` values above 131,072 or 65,536
    slots) and a float32 ``(S, d)`` per-slot buffer besides y."""
    if not x.is_cuda:
        return fused_moe_fwd_plain(x, g_slot, idx, offsets, w1, w2, w3)
    S, L, d, h, E = _check(x, g_slot, idx, offsets, w1, w2, w3)
    _check_tim(tim, idx, L)
    y = torch.zeros(L, d, dtype=torch.float32, device=x.device)
    tc = tensor_core_path(x, (w1, w2, w3))
    if tc:
        hc = pass_width(S, h)
        chunk = torch.empty(S, hc, dtype=x.dtype, device=x.device)
    else:
        hc = general_pass_width(S, h)
        chunk = torch.empty(S, hc, dtype=torch.float32, device=x.device)
    ys = torch.zeros(S, d, dtype=torch.float32, device=x.device)
    if _lib.dry("fused_moe_fwd", cost.fused_moe(S, d, h, False),
                (x, g_slot, idx, offsets, w1, w2, w3, tim), (y,)):
        return y
    code = _lib.lib().repro_fused_moe_fwd(
        _lib.DTYPE_CODE[x.dtype], int(tc), x.data_ptr(), g_slot.data_ptr(),
        idx.data_ptr(), offsets.data_ptr(), w1.data_ptr(), w2.data_ptr(),
        w3.data_ptr(), y.data_ptr(), chunk.data_ptr(), hc, S, L, d, h, E,
        ys.data_ptr(), tim.data_ptr(), tim.shape[1], _lib.stream_ptr(x))
    _lib.check("repro_fused_moe_fwd", code)
    fused_moe_fwd.launches += 1
    return y


def fused_moe_bwd(x: torch.Tensor, dy: torch.Tensor, g_slot: torch.Tensor,
                  idx: torch.Tensor, offsets: torch.Tensor, w1: torch.Tensor,
                  w2: torch.Tensor, w3: torch.Tensor,
                  tim: torch.Tensor | None = None):
    """Backward of :func:`fused_moe_fwd`; ``dy`` (L, d) in ``x.dtype``;
    ``tim`` as there.  Returns ``(dx (L, d), dgates_slot (S,), dw1, dw2,
    dw3)``, all float32.  A CPU tensor takes the plain version; a CUDA
    tensor launches the kernels (counted once per call in
    ``fused_moe_bwd.launches``).  The call allocates a ``(3, S, hc)``
    workspace within :data:`BWD_CHUNK_CAP_BYTES` (bf16 on the tensor-core
    path, :func:`bwd_pass_width`; float32 on the general one,
    :func:`general_bwd_pass_width`), a float32 ``(⌈h/128⌉, S)`` buffer of
    dgates partials (``(⌈h/32⌉, S)`` on the general path) and a float32
    ``(S, d)`` per-slot dx besides the outputs."""
    if not x.is_cuda:
        return fused_moe_bwd_plain(x, dy, g_slot, idx, offsets, w1, w2, w3)
    S, L, d, h, E = _check(x, g_slot, idx, offsets, w1, w2, w3, dy=dy)
    _check_tim(tim, idx, L)
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.zeros(L, d, **f32)
    dg = torch.empty(S, **f32)
    dw1, dw2 = torch.empty(E, d, h, **f32), torch.empty(E, d, h, **f32)
    dw3 = torch.empty(E, h, d, **f32)
    tc = tensor_core_path(x, (w1, w2, w3), dy)
    if tc:
        hc = bwd_pass_width(S, h)
        ws = torch.empty(3, S, hc, dtype=x.dtype, device=x.device)
        part = torch.empty(-(-h // H_TILE), S, **f32)
    else:
        hc = general_bwd_pass_width(S, h)
        ws = torch.empty(3, S, hc, **f32)
        part = torch.empty(-(-h // GENERAL_H_TILE), S, **f32)
    dxs = torch.zeros(S, d, **f32)
    if _lib.dry("fused_moe_bwd", cost.fused_moe(S, d, h, True),
                (x, dy, g_slot, idx, offsets, w1, w2, w3, tim),
                (dx, dg, dw1, dw2, dw3)):
        return dx, dg, dw1, dw2, dw3
    code = _lib.lib().repro_fused_moe_bwd(
        _lib.DTYPE_CODE[x.dtype], int(tc), x.data_ptr(), dy.data_ptr(),
        g_slot.data_ptr(), idx.data_ptr(), offsets.data_ptr(), w1.data_ptr(),
        w2.data_ptr(), w3.data_ptr(), dx.data_ptr(), dg.data_ptr(),
        dw1.data_ptr(), dw2.data_ptr(), dw3.data_ptr(), ws.data_ptr(),
        part.data_ptr(), hc, S, L, d, h, E, dxs.data_ptr(), tim.data_ptr(),
        tim.shape[1], _lib.stream_ptr(x))
    _lib.check("repro_fused_moe_bwd", code)
    fused_moe_bwd.launches += 1
    return dx, dg, dw1, dw2, dw3


fused_moe_fwd.launches = 0
fused_moe_bwd.launches = 0
