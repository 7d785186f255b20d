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

Bound on the card: bytes (the live K/V rows).  The TPU carries the
online softmax across an ordered page axis; ``csrc/paged_attention.cu``
splits the page walk instead (flash decoding): a grid of (request, kv
head, split) blocks, each over ``pages_per_split`` pages
(:func:`split_pages`), writes its split's ``(m, l, acc)`` to a float32
workspace that the wrapper allocates, and a second kernel merges the
splits in order.  :func:`paged_attention_split_plain` and
:func:`paged_attention_int8_split_plain` compute the same per-split
states and merge them as the kernel does: the CPU oracle of the split
walk.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.kernels import _lib, cost

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


def split_pages(B: int, Hkv: int, pps: int, n_sm: int) -> int:
    """Pages per split of the card's page walk: the whole table's splits
    (B x Hkv x ceil(pps / pages) blocks) come to about 8 blocks per SM
    (2 pages a split at the serving smoke's 4 requests x 8 kv heads x 64
    pages), and at most 32 pages, the page-table entries a block holds
    one per lane (long tables get more splits).  Blocks of splits past a
    request's position exit after reading it, so the live ones (decode
    positions fill part of the table) still cover the SMs."""
    return min(32, max(1, -(-pps * B * Hkv // (8 * n_sm))))


def _split_walk(q, kg, vg, ksc, vsc, positions, span, window, cap):
    """Per-split online-softmax states over ``span`` positions each, merged
    in split order.  kg, vg: (B, T, Hkv, Dh) float32; ksc, vsc: (B, T, Hkv)
    or None."""
    B, _, Hq, Dh = q.shape
    T, Hkv = kg.shape[1], kg.shape[2]
    G = Hq // Hkv
    n = -(-T // span)
    qf = q.reshape(B, Hkv, G, Dh).float() * Dh ** -0.5
    s = torch.einsum("bhgd,bthd->bhgt", qf, kg)
    if ksc is not None:
        s = s * ksc.transpose(1, 2)[:, :, None, :]
    if cap:
        s = cap * torch.tanh(s / cap)
    t_ids = torch.arange(n * span, device=q.device)
    pos = positions.long()[:, None]
    valid = (t_ids[None, :] <= pos) & (t_ids[None, :] < T)
    if window:
        valid &= t_ids[None, :] > pos - window
    s = torch.nn.functional.pad(s, (0, n * span - T))
    s = s.reshape(B, Hkv, G, n, span)
    valid = valid.reshape(B, 1, 1, n, span)
    m = torch.where(valid, s, -torch.inf).amax(-1)            # (B,Hkv,G,n)
    p = torch.where(valid, torch.exp(s - torch.where(
        torch.isinf(m), 0.0, m)[..., None]), 0.0)
    l = p.sum(-1)
    if vsc is not None:
        v_sc = torch.nn.functional.pad(vsc.transpose(1, 2), (0, n * span - T))
        p = p * v_sc.reshape(B, Hkv, 1, n, span)
    vs = torch.nn.functional.pad(vg, (0, 0, 0, 0, 0, n * span - T))
    acc = torch.einsum("bhgnt,bnthd->bhgnd", p,
                       vs.reshape(B, n, span, Hkv, Dh))
    # the merge kernel: splits in order, an empty split (m = -inf) skipped
    M = m.amax(-1, keepdim=True)
    f = torch.where(torch.isinf(m), 0.0, torch.exp(m - M))
    out = (acc * f[..., None]).sum(-2) / torch.clamp(
        (l * f).sum(-1), min=1e-30)[..., None]
    return out.reshape(B, 1, Hq, Dh).to(q.dtype)


def _gather_pages(a, page_table):
    B, pps = page_table.shape
    g = a[page_table.long()]
    return g.reshape((B, pps * a.shape[1]) + a.shape[2:]).float()


def paged_attention_split_plain(q: torch.Tensor, k_pages: torch.Tensor,
                                v_pages: torch.Tensor,
                                page_table: torch.Tensor,
                                positions: torch.Tensor, *,
                                pages_per_split: int, window: int = 0,
                                cap: float = 0.0) -> torch.Tensor:
    """The kernel's split walk in plain PyTorch: per split of
    ``pages_per_split`` pages the float32 ``(m, l, acc)`` of its unmasked
    positions (an empty split has ``m = -inf``, ``l = 0``), merged in
    split order.  Same arguments and result as :func:`paged_attention`."""
    span = pages_per_split * k_pages.shape[1]
    return _split_walk(q, _gather_pages(k_pages, page_table),
                       _gather_pages(v_pages, page_table), None, None,
                       positions, span, window, cap)


def paged_attention_int8_split_plain(q: torch.Tensor, k_pages: torch.Tensor,
                                     v_pages: torch.Tensor,
                                     k_scale: torch.Tensor,
                                     v_scale: torch.Tensor,
                                     page_table: torch.Tensor,
                                     positions: torch.Tensor, *,
                                     pages_per_split: int, window: int = 0,
                                     cap: float = 0.0) -> torch.Tensor:
    """:func:`paged_attention_split_plain` over int8 pages: scores times
    ``k_scale`` before the softcap, ``l`` over the unscaled
    probabilities, probabilities times ``v_scale`` against the int8
    values."""
    span = pages_per_split * k_pages.shape[1]
    return _split_walk(q, _gather_pages(k_pages, page_table),
                       _gather_pages(v_pages, page_table),
                       _gather_pages(k_scale, page_table)[..., 0],
                       _gather_pages(v_scale, page_table)[..., 0],
                       positions, span, window, cap)


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
    vec = 16 // k_pages.element_size()
    lanes = Dh // vec
    if Dh % vec or lanes > 32 or lanes & (lanes - 1) or Hq // Hkv > 8:
        raise ValueError(
            f"paged attention kernel takes rows of 16 to 512 bytes in a power "
            f"of two of 16-byte pieces and a GQA group of at most 8; got "
            f"Dh={Dh} of {k_pages.dtype}, group {Hq // Hkv}")


@functools.cache
def _sm_count(device_index: int) -> int:
    return _lib.sm_count(torch.device("cuda", device_index))


def _workspace(q, Hkv, pps):
    """Pages per split and the float32 split workspace, per (request,
    query head, split) ``acc`` (Dh values) and then ``(m, l)``: returns
    the pages, the tensor and the offset of ``(m, l)`` in it."""
    B, _, Hq, Dh = q.shape
    idx = q.device.index if q.device.index is not None else \
        torch.cuda.current_device()
    pages = split_pages(B, Hkv, pps, _sm_count(idx))
    n_acc = B * Hq * -(-pps // pages) * Dh
    ws = torch.empty(n_acc + 2 * n_acc // Dh, dtype=torch.float32,
                     device=q.device)
    return pages, ws, 4 * n_acc


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
    pps = page_table.shape[1]
    pages, ws, ml_at = _workspace(q, Hkv, pps)
    out = torch.empty_like(q)
    if _lib.dry("paged_attention", cost.paged_attention(B, Hq, Dh, pps * ps),
                (q, k_pages, v_pages, page_table, positions), (out,)):
        return out
    ws_acc, ws_ml = ws.data_ptr(), ws.data_ptr() + ml_at
    code = _lib.lib().repro_paged_attention(
        _lib.DTYPE_CODE[dt], q.data_ptr(), k_pages.data_ptr(),
        v_pages.data_ptr(), page_table.data_ptr(), positions.data_ptr(),
        out.data_ptr(), ws_acc, ws_ml, B, Hq, Hkv, Dh, ps, pps, pages,
        int(window), float(cap), float(Dh ** -0.5), _lib.stream_ptr(q))
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
    pps = page_table.shape[1]
    pages, ws, ml_at = _workspace(q, Hkv, pps)
    out = torch.empty_like(q)
    if _lib.dry("paged_attention_int8",
                cost.paged_attention(B, Hq, Dh, pps * ps),
                (q, k_pages, v_pages, k_scale, v_scale, page_table,
                 positions), (out,)):
        return out
    ws_acc, ws_ml = ws.data_ptr(), ws.data_ptr() + ml_at
    code = _lib.lib().repro_paged_attention_int8(
        _lib.DTYPE_CODE[q.dtype], q.data_ptr(), k_pages.data_ptr(),
        v_pages.data_ptr(), k_scale.data_ptr(), v_scale.data_ptr(),
        page_table.data_ptr(), positions.data_ptr(), out.data_ptr(),
        ws_acc, ws_ml, B, Hq, Hkv, Dh, ps, pps, pages, int(window),
        float(cap), float(Dh ** -0.5), _lib.stream_ptr(q))
    _lib.check("repro_paged_attention_int8", code)
    paged_attention_int8.launches += 1
    return out


paged_attention.launches = 0
paged_attention_int8.launches = 0
