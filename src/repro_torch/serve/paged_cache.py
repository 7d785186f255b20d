"""Block-paged KV storage for the serving engine.

Mirrors ``repro/serve/paged_cache.py``:

* :class:`PagedKV` — one layer's page pool, ``(P, page_size, Hkv, Dh)`` in
  the model dtype, or int8 values with float16 per-(position, head) scales
  ``(P, page_size, Hkv, 1)`` (``serve/kv_quant``'s scheme, applied at
  write time);
* per-request page tables ``(B, pages_per_seq)`` map logical positions to
  physical pages; unused entries point at the reserved **trash page**
  (page 0), so writes to padded positions land there and reads of it are
  always masked;
* :class:`PagePool` — the host-side free-list allocator.

The port updates the pools in place (``index_put_``) where the reference
returns new arrays: a pool is a few hundred MB at full width, and a copy
per write would double the cache.  The prefix-sharing trie is not ported
yet.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels.paged_attention import (paged_attention_int8 as
                                                 _paged_attention_int8_kernel)
from repro_torch.kernels.paged_attention import (paged_attention as
                                                 _paged_attention_kernel)
from repro_torch.serve.kv_quant import quantize

NEG_INF = -1e30

#: physical page 0 is never allocated (see module docstring)
TRASH_PAGE = 0


class PagedKV(NamedTuple):
    """One attention layer's page pool: ``k``/``v`` ``(P, page_size, Hkv,
    Dh)`` in the storage dtype; int8 storage carries float16 per-vector
    scales ``(P, page_size, Hkv, 1)`` (``None`` otherwise)."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: torch.Tensor | None = None
    v_scale: torch.Tensor | None = None

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @property
    def page_size(self) -> int:
        return self.k.shape[1]


def init_paged_kv(num_pages: int, page_size: int, n_kv: int, head_dim: int,
                  dtype, device, *, quantized: bool = False) -> PagedKV:
    shape = (num_pages, page_size, n_kv, head_dim)
    if quantized:
        sshape = shape[:-1] + (1,)
        return PagedKV(
            k=torch.zeros(shape, dtype=torch.int8, device=device),
            v=torch.zeros(shape, dtype=torch.int8, device=device),
            k_scale=torch.zeros(sshape, dtype=torch.float16, device=device),
            v_scale=torch.zeros(sshape, dtype=torch.float16, device=device))
    return PagedKV(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))


# ---------------------------------------------------------------------------
# writes (in place)
# ---------------------------------------------------------------------------


def _scatter(pages: PagedKV, k, v, phys, off) -> None:
    """Write flattened k/v rows at ``(phys, off)`` page coordinates,
    quantized first when the pool is int8."""
    if pages.quantized:
        q, scale = quantize(torch.stack((k, v)))   # per vector: k, v at once
        pages.k[phys, off], pages.v[phys, off] = q[0], q[1]
        pages.k_scale[phys, off], pages.v_scale[phys, off] = scale[0], scale[1]
    else:
        pages.k[phys, off] = k.to(pages.k.dtype)
        pages.v[phys, off] = v.to(pages.v.dtype)


def write_prefill(pages: PagedKV, k: torch.Tensor, v: torch.Tensor,
                  page_table: torch.Tensor) -> PagedKV:
    """Scatter a right-padded prompt's k/v ``(B, S, Hkv, Dh)`` through
    ``page_table``: position ``t`` of request ``b`` lands in
    ``page_table[b, t // page_size]`` at offset ``t % page_size``."""
    B = k.shape[0]
    zeros = torch.zeros(B, dtype=torch.int32, device=k.device)
    return write_prefill_offset(pages, k, v, page_table, zeros)


def write_prefill_offset(pages: PagedKV, k: torch.Tensor, v: torch.Tensor,
                         page_table: torch.Tensor,
                         offsets: torch.Tensor) -> PagedKV:
    """:func:`write_prefill` with per-request start positions: row ``t`` of
    request ``b`` lands at absolute position ``offsets[b] + t``.  Columns
    past the table's width (a power-of-two bucket may overshoot it) are
    routed to the trash page explicitly, so the pad tail can never alias
    onto the request's own last page."""
    B, S = k.shape[:2]
    ps = pages.page_size
    t_abs = offsets[:, None].long() + torch.arange(S, device=k.device)
    col = t_abs // ps
    ncols = page_table.shape[1]
    in_table = torch.gather(page_table.long(), 1, col.clamp(max=ncols - 1))
    phys = torch.where(col < ncols, in_table,
                       torch.full_like(in_table, TRASH_PAGE)).reshape(-1)
    off = (t_abs % ps).reshape(-1)
    _scatter(pages, k.reshape((B * S,) + k.shape[2:]),
             v.reshape((B * S,) + v.shape[2:]), phys, off)
    return pages


def write_decode(pages: PagedKV, k: torch.Tensor, v: torch.Tensor,
                 page_table: torch.Tensor,
                 positions: torch.Tensor) -> PagedKV:
    """Scatter one token per request: ``k``/``v`` ``(B, 1, Hkv, Dh)`` at
    per-request absolute ``positions`` ``(B,)``."""
    B = k.shape[0]
    ps = pages.page_size
    pos = positions.long()
    phys = page_table.long()[torch.arange(B, device=k.device), pos // ps]
    _scatter(pages, k[:, 0], v[:, 0], phys, pos % ps)
    return pages


# ---------------------------------------------------------------------------
# attend
# ---------------------------------------------------------------------------


def paged_gather_attention(q: torch.Tensor, pages: PagedKV,
                           page_table: torch.Tensor, pos_q: torch.Tensor, *,
                           window: int = 0, cap: float = 0.0) -> torch.Tensor:
    """Attention of ``Sq`` query tokens per request against the request's
    gathered pages (the reference's dense path, same rounding points: the
    scaled query is cast to the page dtype, scores and the value sum are
    float32, probabilities are cast to the page dtype).  Over int8 pages
    the scaled query stays in its dtype, the scores of the int8 keys are
    multiplied by ``k_scale`` and the probabilities by ``v_scale``.

    q: ``(B, Sq, Hq, Dh)``; ``pos_q`` ``(B, Sq)`` absolute positions."""
    B, Sq, Hq, Dh = q.shape
    ps = pages.page_size
    pt = page_table.long()
    T = pt.shape[1] * ps
    Hkv = pages.k.shape[2]
    G = Hq // Hkv

    def gather(a):
        return a[pt].reshape((B, T) + a.shape[2:])

    def scales(a):   # (P, ps, Hkv, 1) -> (B, 1, Hkv, 1, T) float32
        return gather(a)[..., 0].float().transpose(1, 2)[:, None, :, None, :]

    kg, vg = gather(pages.k), gather(pages.v)
    qf = q.reshape(B, Sq, Hkv, G, Dh) * Dh ** -0.5
    if not pages.quantized:
        qf = qf.to(kg.dtype)
    s = torch.einsum("bqhgd,bthd->bqhgt", qf.float(), kg.float())
    if pages.quantized:
        s = s * scales(pages.k_scale)
    if cap:
        s = cap * torch.tanh(s / cap)
    t_ids = torch.arange(T, device=q.device)
    pos = pos_q.long()[:, :, None]
    valid = t_ids[None, None, :] <= pos                         # (B, Sq, T)
    if window:
        valid &= t_ids[None, None, :] > pos - window
    s = torch.where(valid[:, :, None, None, :], s,
                    torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    if pages.quantized:
        p = p * scales(pages.v_scale)
    else:
        p = p.to(vg.dtype).float()
    out = torch.einsum("bqhgt,bthd->bqhgd", p, vg.float())
    return out.reshape(B, Sq, Hq, Dh).to(q.dtype)


def paged_attention(q: torch.Tensor, pages: PagedKV,
                    page_table: torch.Tensor, positions: torch.Tensor, *,
                    window: int = 0, cap: float = 0.0) -> torch.Tensor:
    """One-token attention against the paged cache, through the paged
    attention kernel for the pool's storage (its plain version for CPU
    tensors).  q: ``(B, 1, Hq, Dh)``; ``positions`` ``(B,)`` int32 current
    positions."""
    if pages.quantized:
        return _paged_attention_int8_kernel(
            q, pages.k, pages.v, pages.k_scale, pages.v_scale, page_table,
            positions, window=window, cap=cap)
    return _paged_attention_kernel(q, pages.k, pages.v, page_table,
                                   positions, window=window, cap=cap)


# ---------------------------------------------------------------------------
# host-side page allocator
# ---------------------------------------------------------------------------


class PagePool:
    """Free-list page allocator (host side; pages are ints).

    Page ``TRASH_PAGE`` is reserved.  Frees push onto the list tail and
    allocs pop from it (LIFO), so a request admitted right after another
    finishes reuses the same physical pages, as in the reference."""

    def __init__(self, num_pages: int):
        if num_pages < 2:
            raise ValueError("need >= 2 pages (one is the reserved trash page)")
        self.num_pages = num_pages
        self._free = list(range(num_pages - 1, TRASH_PAGE, -1))
        self._free_set = set(self._free)
        self.min_free = len(self._free)       # low-water mark (stats)

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> list[int]:
        if n > len(self._free):
            raise RuntimeError(f"page pool exhausted: want {n}, "
                               f"have {len(self._free)}")
        pages = [self._free.pop() for _ in range(n)]
        self._free_set.difference_update(pages)
        self.min_free = min(self.min_free, len(self._free))
        return pages

    def free(self, pages: list[int]) -> None:
        """Return pages; the whole batch is validated before any is freed.
        Pages rejoin in reversed order (the reference's LIFO reuse)."""
        seen = set()
        for p in pages:
            if p == TRASH_PAGE or not (0 < p < self.num_pages):
                raise ValueError(f"freeing invalid page {p}")
            if p in self._free_set or p in seen:
                raise ValueError(f"double free of page {p}")
            seen.add(p)
        for p in reversed(pages):
            self._free.append(p)
            self._free_set.add(p)


def pages_needed(n_tokens: int, page_size: int) -> int:
    return -(-max(n_tokens, 1) // page_size)
