"""Paged decode attention: CUDA kernel and its plain version, over
model-dtype pages and over int8 pages.

Replaces ``repro/kernels/paged_attention.py:paged_attention_pallas``
(kernel ``_kernel``, both branches).  One query token per request
attends its cached keys and values through its page table: scores in
float32 from ``q * Dh**-0.5``, optional softcap, masks ``t <= pos`` and
``t > pos - window``, softmax, float32 accumulate, output
``acc / max(l, 1e-30)`` in ``q.dtype``.  Over int8 pages with float16
per-(position, head) scales (``serve/kv_quant``), the scale multiplies
each score (``k_scale``, before the softcap) and each probability
(``v_scale``, after the softmax's denominator is taken), as in the TPU
kernel's quantized branch; no dequantized page is written.

Bound on the card: bytes (the live K/V rows).  ``csrc/paged_attention.cu``
runs one block per (request, kv head) that walks the request's live pages
(skipping pages wholly before the window) with the online softmax held in
the block, instead of the TPU's page axis carried across grid steps.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _lib

NEG_INF = -1e30


def paged_attention_plain(q: torch.Tensor, k_pages: torch.Tensor,
                          v_pages: torch.Tensor, page_table: torch.Tensor,
                          positions: torch.Tensor, *, window: int = 0,
                          cap: float = 0.0) -> torch.Tensor:
    """Gather every table page, then masked float32 softmax attention."""
    B, _, Hq, Dh = q.shape
    _, ps, Hkv, _ = k_pages.shape
    G = Hq // Hkv
    pt = page_table.long()
    T = pt.shape[1] * ps
    kg = k_pages[pt].reshape(B, T, Hkv, Dh).float()
    vg = v_pages[pt].reshape(B, T, Hkv, Dh).float()
    qf = q.reshape(B, Hkv, G, Dh).float() * Dh ** -0.5
    s = torch.einsum("bhgd,bthd->bhgt", qf, kg)
    if cap:
        s = cap * torch.tanh(s / cap)
    t_ids = torch.arange(T, device=q.device)
    pos = positions.long()[:, None]
    valid = t_ids[None, :] <= pos
    if window:
        valid &= t_ids[None, :] > pos - window
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgt,bthd->bhgd", p, vg)
    return out.reshape(B, 1, Hq, Dh).to(q.dtype)


def paged_attention_int8_plain(q: torch.Tensor, k_pages: torch.Tensor,
                               v_pages: torch.Tensor, k_scale: torch.Tensor,
                               v_scale: torch.Tensor,
                               page_table: torch.Tensor,
                               positions: torch.Tensor, *, window: int = 0,
                               cap: float = 0.0) -> torch.Tensor:
    """Plain version over int8 pages: gather every table page, int8 scores
    times ``k_scale``, masked float32 softmax, probabilities times
    ``v_scale`` against the int8 values."""
    B, _, Hq, Dh = q.shape
    _, ps, Hkv, _ = k_pages.shape
    G = Hq // Hkv
    pt = page_table.long()
    T = pt.shape[1] * ps

    def gather(a):
        return a[pt].reshape((B, T) + a.shape[2:]).float()

    kg, vg = gather(k_pages), gather(v_pages)
    ksc = gather(k_scale)[..., 0].transpose(1, 2)[:, :, None, :]
    vsc = gather(v_scale)[..., 0].transpose(1, 2)[:, :, None, :]
    qf = q.reshape(B, Hkv, G, Dh).float() * Dh ** -0.5
    s = torch.einsum("bhgd,bthd->bhgt", qf, kg) * ksc
    if cap:
        s = cap * torch.tanh(s / cap)
    t_ids = torch.arange(T, device=q.device)
    pos = positions.long()[:, None]
    valid = t_ids[None, :] <= pos
    if window:
        valid &= t_ids[None, :] > pos - window
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1) * vsc
    out = torch.einsum("bhgt,bthd->bhgd", p, vg)
    return out.reshape(B, 1, Hq, Dh).to(q.dtype)


def _check_paged(q, k_pages, v_pages, page_table, positions, page_dtype):
    dt = q.dtype
    if dt not in _lib.DTYPE_CODE:
        raise ValueError(f"paged attention takes a float32 or bfloat16 "
                         f"query, got {dt}")
    _lib.require(q, "q", dtype=dt, ndim=4)
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        _lib.require(t, name, dtype=page_dtype, ndim=4, device=q.device)
    _lib.require(page_table, "page_table", dtype=torch.int32, ndim=2,
                 device=q.device)
    _lib.require(positions, "positions", dtype=torch.int32, ndim=1,
                 device=q.device)
    B, one, Hq, Dh = q.shape
    _, ps, Hkv, dkv = k_pages.shape
    if one != 1 or dkv != Dh or Hq % Hkv or v_pages.shape != k_pages.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)}, pages "
                         f"{tuple(k_pages.shape)} / {tuple(v_pages.shape)}")
    if page_table.shape[0] != B or positions.shape[0] != B:
        raise ValueError("page_table and positions need one row per request")


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, page_table: torch.Tensor,
                    positions: torch.Tensor, *, window: int = 0,
                    cap: float = 0.0) -> torch.Tensor:
    """q: (B, 1, Hq, Dh); pages: (P, page_size, Hkv, Dh); page_table:
    (B, pages_per_seq) int32; positions: (B,) int32, each request's current
    (already written) position.  Returns (B, 1, Hq, Dh).  A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel (counted in
    ``paged_attention.launches``)."""
    if not q.is_cuda:
        return paged_attention_plain(q, k_pages, v_pages, page_table,
                                     positions, window=window, cap=cap)
    _check_paged(q, k_pages, v_pages, page_table, positions, q.dtype)
    dt = q.dtype
    B, _, Hq, Dh = q.shape
    _, ps, Hkv, _ = k_pages.shape
    out = torch.empty_like(q)
    code = _lib.lib().repro_paged_attention(
        _lib.DTYPE_CODE[dt], q.data_ptr(), k_pages.data_ptr(),
        v_pages.data_ptr(), page_table.data_ptr(), positions.data_ptr(),
        out.data_ptr(), B, Hq, Hkv, Dh, ps, page_table.shape[1], int(window),
        float(cap), float(Dh ** -0.5), _lib.stream_ptr(q))
    _lib.check("repro_paged_attention", code)
    paged_attention.launches += 1
    return out


def paged_attention_int8(q: torch.Tensor, k_pages: torch.Tensor,
                         v_pages: torch.Tensor, k_scale: torch.Tensor,
                         v_scale: torch.Tensor, page_table: torch.Tensor,
                         positions: torch.Tensor, *, window: int = 0,
                         cap: float = 0.0) -> torch.Tensor:
    """:func:`paged_attention` over int8 pages ``(P, page_size, Hkv, Dh)``
    with float16 scales ``(P, page_size, Hkv, 1)``; q in float32 or
    bfloat16.  A CPU tensor takes the plain version; a CUDA tensor launches
    the kernel's int8 instantiation (counted in
    ``paged_attention_int8.launches``)."""
    if not q.is_cuda:
        return paged_attention_int8_plain(q, k_pages, v_pages, k_scale,
                                          v_scale, page_table, positions,
                                          window=window, cap=cap)
    _check_paged(q, k_pages, v_pages, page_table, positions, torch.int8)
    for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
        _lib.require(t, name, dtype=torch.float16, ndim=4, device=q.device)
        if t.shape != k_pages.shape[:3] + (1,):
            raise ValueError(f"{name} {tuple(t.shape)} does not match the "
                             f"pages {tuple(k_pages.shape)}")
    B, _, Hq, Dh = q.shape
    _, ps, Hkv, _ = k_pages.shape
    out = torch.empty_like(q)
    code = _lib.lib().repro_paged_attention_int8(
        _lib.DTYPE_CODE[q.dtype], q.data_ptr(), k_pages.data_ptr(),
        v_pages.data_ptr(), k_scale.data_ptr(), v_scale.data_ptr(),
        page_table.data_ptr(), positions.data_ptr(), out.data_ptr(), B, Hq,
        Hkv, Dh, ps, page_table.shape[1], int(window), float(cap),
        float(Dh ** -0.5), _lib.stream_ptr(q))
    _lib.check("repro_paged_attention_int8", code)
    paged_attention_int8.launches += 1
    return out


paged_attention.launches = 0
paged_attention_int8.launches = 0
