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
* :class:`PagePool` — the host-side free-list allocator, refcounted: a
  physical page may be mapped read-only into several page tables (prefix
  sharing) and rejoins the free list when its last reference drops;
* :class:`PrefixCache` — a trie over full-page prompt chunks
  (:func:`page_keys`) whose nodes pin physical pages of prompt KV; a later
  prompt with a page-aligned shared prefix maps them and prefills only
  its suffix, and the engine forks (:func:`copy_page`) a shared page
  before it writes into it (copy-on-write).

The port updates the pools in place (``index_put_``, ``copy_``) where the
reference returns new arrays: a pool is a few hundred MB at full width,
and a copy per write would double the cache.

Decode attention has two registered implementations under the
reference's names: ``dense`` is :func:`paged_gather_attention` (plain
PyTorch, as the reference's is plain jnp) and ``pallas`` is the
hand-written kernel of ``kernels/paged_attention.py``
(``csrc/paged_attention.cu``; its plain version for CPU tensors).
:func:`resolve_paged_attn` applies arg > config > ``REPRO_PAGED_ATTN`` >
auto.  Auto differs from the reference's on purpose (ROADMAP.md §C, C6):
the reference's auto is ``dense`` because Pallas runs interpreted on a
CPU; the port's is the kernel for a CUDA engine and ``dense`` for a CPU
one.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
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


def copy_page(pages: PagedKV, src: int, dst: int) -> PagedKV:
    """Copy-on-write fork: physical page ``src``'s contents into ``dst``,
    in place, across ``k``, ``v`` and (int8 pools) the scales.  The
    writer's table is then remapped to ``dst``; ``src`` keeps serving its
    other readers unchanged."""
    for a in pages:
        if a is not None:
            a[dst].copy_(a[src])
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
                    window: int = 0, cap: float = 0.0,
                    impl: str = "pallas") -> torch.Tensor:
    """One-token attention against the paged cache.  q: ``(B, 1, Hq,
    Dh)``; ``positions`` ``(B,)`` int32 current positions.  ``impl``:
    ``pallas`` is the paged attention kernel for the pool's storage (its
    plain version for CPU tensors), ``dense`` the plain gather over every
    table page (:func:`paged_gather_attention`)."""
    if impl == "dense":
        return paged_gather_attention(q, pages, page_table,
                                      positions[:, None], window=window,
                                      cap=cap)
    if impl != "pallas":
        raise ValueError(f"unknown paged-attention impl {impl!r}; "
                         f"known: {paged_attn_names()}")
    if pages.quantized:
        return _paged_attention_int8_kernel(
            q, pages.k, pages.v, pages.k_scale, pages.v_scale, page_table,
            positions, window=window, cap=cap)
    return _paged_attention_kernel(q, pages.k, pages.v, page_table,
                                   positions, window=window, cap=cap)


# ---------------------------------------------------------------------------
# paged-attention implementation registry (the gmm_backend pattern)
# ---------------------------------------------------------------------------

PAGED_ATTN_ENV = "REPRO_PAGED_ATTN"


class DensePagedAttn:
    """:func:`paged_gather_attention`: plain PyTorch, available
    everywhere."""

    name = "dense"

    @staticmethod
    def available() -> bool:
        return True


class PallasPagedAttn:
    """The hand-written paged attention kernel (``csrc/paged_attention.cu``,
    model-dtype and int8 pages), built at first use on the card; its plain
    version serves CPU tensors."""

    name = "pallas"

    @staticmethod
    def available() -> bool:
        return True


_ATTN_REGISTRY: dict[str, object] = {
    b.name: b for b in (DensePagedAttn, PallasPagedAttn)}


def paged_attn_names() -> list[str]:
    return list(_ATTN_REGISTRY)


def available_paged_attn() -> list[str]:
    return [n for n, b in _ATTN_REGISTRY.items() if b.available()]


@dataclass(frozen=True)
class ResolvedPagedAttn:
    """A validated paged-attention choice with the precedence slot that
    chose it (``arg`` | ``config`` | ``env`` | ``auto``) and the PyTorch
    version it was resolved on."""

    name: str
    source: str
    torch_version: str

    def __str__(self) -> str:
        return self.name


def _validate_attn(name: str) -> str:
    if name not in _ATTN_REGISTRY:
        raise ValueError(f"unknown paged-attention impl {name!r}; "
                         f"known: {paged_attn_names()}")
    if not _ATTN_REGISTRY[name].available():
        raise RuntimeError(
            f"paged-attention impl {name!r} is not available on torch "
            f"{torch.__version__}; available: {available_paged_attn()}")
    return name


def resolve_paged_attn(impl: str | ResolvedPagedAttn | None = None, *,
                       config: str | None = None,
                       device=None) -> ResolvedPagedAttn:
    """arg > config > ``REPRO_PAGED_ATTN`` > auto.  Auto is the kernel
    (``pallas``) on a CUDA ``device`` and ``dense`` otherwise (C6)."""
    if isinstance(impl, ResolvedPagedAttn):
        return impl
    chain = (("arg", impl), ("config", config),
             ("env", os.environ.get(PAGED_ATTN_ENV, "").strip() or None))
    for source, cand in chain:
        if cand not in (None, "", "auto"):
            return ResolvedPagedAttn(_validate_attn(cand), source,
                                     torch.__version__)
    auto = ("pallas" if device is not None
            and torch.device(device).type == "cuda" else "dense")
    return ResolvedPagedAttn(auto, "auto", torch.__version__)


# ---------------------------------------------------------------------------
# host-side page allocator
# ---------------------------------------------------------------------------


class PagePool:
    """Refcounted free-list page allocator (host side; pages are ints).

    Page ``TRASH_PAGE`` is reserved.  Frees push onto the list tail and
    allocs pop from it (LIFO), so a request admitted right after another
    finishes reuses the same physical pages, as in the reference.
    :meth:`share` takes an extra reference on an allocated page and
    :meth:`release` drops one; a page rejoins the free list when its count
    reaches zero."""

    def __init__(self, num_pages: int):
        if num_pages < 2:
            raise ValueError("need >= 2 pages (one is the reserved trash page)")
        self.num_pages = num_pages
        self._free = list(range(num_pages - 1, TRASH_PAGE, -1))
        self._free_set = set(self._free)
        self._refs = [0] * num_pages
        self.min_free = len(self._free)       # low-water mark (stats)

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def refcount(self, page: int) -> int:
        return self._refs[page]

    def alloc(self, n: int) -> list[int]:
        """Pop ``n`` pages, each born with one reference."""
        if n > len(self._free):
            raise RuntimeError(f"page pool exhausted: want {n}, "
                               f"have {len(self._free)}")
        pages = [self._free.pop() for _ in range(n)]
        self._free_set.difference_update(pages)
        for p in pages:
            self._refs[p] = 1
        self.min_free = min(self.min_free, len(self._free))
        return pages

    def _check_allocated(self, p: int) -> None:
        if p == TRASH_PAGE or not (0 < p < self.num_pages):
            raise ValueError(f"freeing invalid page {p}")
        if p in self._free_set or self._refs[p] < 1:
            raise ValueError(f"double free of page {p}")

    def share(self, page: int) -> int:
        """Take an extra reference on an allocated page; returns the new
        count."""
        self._check_allocated(page)
        self._refs[page] += 1
        return self._refs[page]

    def release(self, page: int) -> int:
        """Drop one reference (the page rejoins the free list at zero);
        returns the remaining count."""
        self._check_allocated(page)
        self._refs[page] -= 1
        if self._refs[page] == 0:
            self._free.append(page)
            self._free_set.add(page)
        return self._refs[page]

    def free(self, pages: list[int]) -> None:
        """Drop one reference on each page.  The whole batch is validated
        before any count changes (a page k times in the batch needs a count
        of at least k); pages reaching zero rejoin in reversed order (the
        reference's LIFO reuse)."""
        occurrences: dict[int, int] = {}
        for p in pages:
            self._check_allocated(p)
            occurrences[p] = occurrences.get(p, 0) + 1
            if occurrences[p] > self._refs[p]:
                raise ValueError(
                    f"double free of page {p}: batch frees it "
                    f"{occurrences[p]} times but refcount is {self._refs[p]}")
        for p in reversed(pages):
            self._refs[p] -= 1
            if self._refs[p] == 0:
                self._free.append(p)
                self._free_set.add(p)


def pages_needed(n_tokens: int, page_size: int) -> int:
    return -(-max(n_tokens, 1) // page_size)


# ---------------------------------------------------------------------------
# prefix-trie page cache (copy-on-write prefix sharing)
# ---------------------------------------------------------------------------


def page_keys(prompt, page_size: int) -> list[bytes]:
    """Content keys of a prompt's full pages: one ``bytes`` per complete
    ``page_size`` chunk (the partial tail page is never shared)."""
    p = np.asarray(prompt, np.int32)
    return [p[i * page_size:(i + 1) * page_size].tobytes()
            for i in range(p.size // page_size)]


class _TrieNode:
    __slots__ = ("page", "children", "last_use")

    def __init__(self, page: int, tick: int):
        self.page = page
        self.children: dict[bytes, _TrieNode] = {}
        self.last_use = tick


class PrefixCache:
    """Trie keyed by full-page prompt content; each node holds one pool
    reference on one physical page of prompt KV.  ``lookup`` walks the
    longest cached chain; ``insert`` adopts a finished request's full
    prompt pages (taking over the caller's reference); ``evict`` releases
    least recently used leaves that no live request maps."""

    def __init__(self):
        self._root: dict[bytes, _TrieNode] = {}
        self._tick = 0
        self._n_pages = 0

    def __len__(self) -> int:
        return self._n_pages

    def lookup(self, keys: list[bytes]) -> list[int]:
        """Longest cached page chain matching ``keys`` front to back."""
        self._tick += 1
        out: list[int] = []
        level = self._root
        for key in keys:
            node = level.get(key)
            if node is None:
                break
            node.last_use = self._tick
            out.append(node.page)
            level = node.children
        return out

    def insert(self, keys: list[bytes], pages: list[int]) -> set[int]:
        """Register ``pages`` along ``keys``.  Returns the pages the cache
        adopted (it now owns the caller's reference on them); a key that
        already had a node adopts nothing."""
        self._tick += 1
        adopted: set[int] = set()
        level = self._root
        for key, page in zip(keys, pages):
            node = level.get(key)
            if node is None:
                node = _TrieNode(page, self._tick)
                level[key] = node
                adopted.add(page)
                self._n_pages += 1
            else:
                node.last_use = self._tick
            level = node.children
        return adopted

    def evict(self, pool: PagePool, n: int) -> int:
        """Release up to ``n`` cached pages to ``pool``, least recently
        used leaves first (a leaf whose page only the cache holds).
        Returns the number evicted."""
        evicted = 0
        while evicted < n:
            leaves: list[tuple[dict, bytes, _TrieNode]] = []
            stack = [(self._root, key, node)
                     for key, node in self._root.items()]
            while stack:
                level, key, node = stack.pop()
                if node.children:
                    stack.extend((node.children, k, c)
                                 for k, c in node.children.items())
                elif pool.refcount(node.page) == 1:
                    leaves.append((level, key, node))
            if not leaves:
                break
            level, key, node = min(leaves, key=lambda t: t[2].last_use)
            del level[key]
            self._n_pages -= 1
            pool.release(node.page)
            evicted += 1
        return evicted
