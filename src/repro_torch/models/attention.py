"""Attention: GQA projections with RoPE, the full-sequence sublayer of
the training forward, its one-token decode branch over a rolling
``KVCache``, and the paged attention sublayer of serving.

Mirrors ``repro/models/attention.py`` (``_project_qkv``,
``attention_sublayer`` with and without a ``KVCache``,
``decode_attention``, ``init_kv_cache``, ``paged_attention_sublayer``
with its prefix-sharing suffix branch).  Full-sequence attention is the
flash-attention kernel when ``cfg.use_pallas`` is set
(``flash_attention_fused``) and the plain chunked computation otherwise
(the reference computes it in plain JAX then); decode attention goes
through the paged-attention implementation ``attn_impl`` (the kernel by
default); the suffix prefill of prefix sharing attends over the request's
gathered pages in plain PyTorch, as the reference does in plain jnp.
Decode against a ``KVCache`` (``decode_step``) is plain PyTorch as well,
as the reference computes it in plain jnp: q is cast to the cache's dtype
before the dot and both dots take float32 results (the reference's
``preferred_element_type``), here by computing them on float32 copies of
the cache's values, whose products and sums are the same.  The cache is
written in place and returned.
Weights are cast to the activations' dtype on use, as in the reference.
The q projection and the output projection are the producers of the
checkpoint tags ``QKV`` and ``ATTN_OUT`` (``core/checkpoint.py:tagged``),
as the reference tags them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.checkpoint import ATTN_OUT, QKV, tagged
from repro_torch.kernels.flash_attention import (flash_attention_fused,
                                                 flash_attention_plain)
from repro_torch.models.common import rms_norm, rope, softcap
from repro_torch.serve import paged_cache as PC

NEG_INF = -1e30


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, slot_pos: torch.Tensor, pos, *,
                     window: int = 0, cap: float = 0.0) -> torch.Tensor:
    """One-token attention against a (possibly rolling) cache.

    q: (B, 1, Hq, Dh); caches: (B, C, Hkv, Dh); slot_pos: (B, C) the
    absolute position in each slot (-1: empty).  ``pos`` is a scalar (the
    batch in lockstep) or (B,) per-request positions."""
    B, _, Hq, Dh = q.shape
    C, Hkv = k_cache.shape[1], k_cache.shape[2]
    G = Hq // Hkv
    pos = torch.as_tensor(pos, device=q.device).reshape(-1).expand(B)
    qf = (q.reshape(B, Hkv, G, Dh) * Dh ** -0.5).to(k_cache.dtype)
    s = torch.einsum("bhgd,bchd->bhgc", qf.float(), k_cache.float())
    s = softcap(s, cap)
    valid = (slot_pos >= 0) & (slot_pos <= pos[:, None])
    if window:
        valid &= slot_pos > pos[:, None] - window
    s = torch.where(valid[:, None, None, :], s, s.new_tensor(NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgc,bchd->bhgd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(B, 1, Hq, Dh).to(q.dtype)


class KVCache(NamedTuple):
    k: torch.Tensor          # (B, C, Hkv, Dh)
    v: torch.Tensor          # (B, C, Hkv, Dh)
    slot_pos: torch.Tensor   # (B, C) int32 absolute position a slot holds
    #                          (-1 empty), per request


def init_kv_cache(batch: int, capacity: int, n_kv: int, head_dim: int,
                  dtype: torch.dtype, device) -> KVCache:
    return KVCache(
        k=torch.zeros(batch, capacity, n_kv, head_dim, dtype=dtype,
                      device=device),
        v=torch.zeros(batch, capacity, n_kv, head_dim, dtype=dtype,
                      device=device),
        slot_pos=torch.full((batch, capacity), -1, dtype=torch.int32,
                            device=device))


def project_qkv(x: torch.Tensor, p: dict, cfg, positions: torch.Tensor,
                num_heads: int | None = None):
    """q/k/v projection, optional qk-norm, RoPE.  ``positions`` may be an
    (S,) shared sequence, a (B,) per-request decode position (S == 1), or a
    (B, S) grid.  ``num_heads`` overrides ``cfg.num_heads`` for q."""
    B, S, _ = x.shape
    H = num_heads if num_heads is not None else cfg.num_heads
    Hkv, dh = cfg.num_kv_heads, cfg.resolved_head_dim
    dt = x.dtype
    wq = p["wq"].to(dt)
    with tagged(QKV):
        q = x @ wq
    q = q.reshape(B, S, H, dh)
    k = (x @ p["wk"].to(dt)).reshape(B, S, Hkv, dh)
    v = (x @ p["wv"].to(dt)).reshape(B, S, Hkv, dh)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    if positions.ndim == 2:
        pos_b = positions
    elif positions.ndim == 1 and S == 1 and positions.shape[0] == B:
        pos_b = positions[:, None]
    else:
        pos_b = positions.expand(B, S)
    return rope(q, pos_b, cfg.rope_theta), rope(k, pos_b, cfg.rope_theta), \
        v, pos_b


def paged_attention_sublayer(x: torch.Tensor, p: dict, cfg, *,
                             is_local: bool, positions: torch.Tensor,
                             pages: PC.PagedKV, page_table: torch.Tensor,
                             prefill: bool,
                             offsets: torch.Tensor | None = None,
                             attn_impl: str = "pallas") -> torch.Tensor:
    """Attention sublayer against a block-paged cache; writes the new k/v
    into ``pages`` in place and returns ``(B, S, d)``.

    ``prefill=True``: ``x`` is the whole right-padded prompt with
    ``positions = arange(S)``; every position's k/v is scattered through
    ``page_table`` and attention is causal over the in-flight k/v.  With
    ``offsets`` ``(B,)`` (prefix sharing), ``x`` is each request's unshared
    suffix and ``positions`` the absolute ``(B, S)`` grid: k/v scatter at
    ``offsets[b] + t`` and attention gathers the request's pages, reading
    the shared prefix from the cache.
    ``prefill=False``: S == 1, ``positions`` are the (B,) per-request write
    positions; the token's k/v is appended and attention walks the pages
    through ``attn_impl`` (``pallas``: the kernel; ``dense``: the plain
    gather)."""
    B, S, _ = x.shape
    window = cfg.sliding_window if is_local else 0
    q, k, v, pos_b = project_qkv(x, p, cfg, positions)
    if prefill and offsets is None:
        PC.write_prefill(pages, k, v, page_table)
        o = _full_attention(q, k, v, cfg, causal=True, window=window)
    elif prefill:
        PC.write_prefill_offset(pages, k, v, page_table, offsets)
        o = PC.paged_gather_attention(q, pages, page_table, pos_b,
                                      window=window, cap=cfg.attn_softcap)
    else:
        PC.write_decode(pages, k, v, page_table, positions)
        o = PC.paged_attention(q, pages, page_table, positions,
                               window=window, cap=cfg.attn_softcap,
                               impl=attn_impl)
    return _out_proj(o.reshape(B, S, -1), p)


def _out_proj(o: torch.Tensor, p: dict) -> torch.Tensor:
    wo = p["wo"].to(o.dtype)
    with tagged(ATTN_OUT):
        return o @ wo


def _full_attention(q, k, v, cfg, *, causal: bool, window: int):
    """Full-sequence attention: the kernel under ``cfg.use_pallas``, else
    the plain chunked attention."""
    if cfg.use_pallas:
        return flash_attention_fused(q, k, v, causal, window,
                                     cfg.attn_softcap)
    return flash_attention_plain(q, k, v, causal=causal, window=window,
                                 cap=cfg.attn_softcap,
                                 chunk=min(cfg.attn_chunk, q.shape[1]))


def attention_sublayer(x: torch.Tensor, p: dict, cfg, *, is_local: bool,
                       positions: torch.Tensor, cache: KVCache | None = None,
                       num_heads: int | None = None):
    """(B, S, d) -> ((B, S, d), new cache).  Without ``cache`` attention
    runs over the whole sequence (training and full-sequence forwards)
    and the new cache is None.  With ``cache`` (decode) S is 1 and
    ``positions`` is the write position, (1,) or per request (B,): the
    token's k/v go to slot ``pos % C`` (a rolling buffer), written in
    place, and the token attends to the slots holding positions up to
    its own (within the window)."""
    B, S, _ = x.shape
    window = cfg.sliding_window if is_local else 0
    q, k, v, pos_b = project_qkv(x, p, cfg, positions, num_heads)
    if cache is None:
        o = _full_attention(q, k, v, cfg, causal=cfg.causal, window=window)
    else:
        pos = pos_b[:, 0].expand(B)
        slot = (pos % cache.k.shape[1]).long()
        bidx = torch.arange(B, device=x.device)
        cache.k[bidx, slot] = k[:, 0].to(cache.k.dtype)
        cache.v[bidx, slot] = v[:, 0].to(cache.v.dtype)
        cache.slot_pos[bidx, slot] = pos.to(torch.int32)
        o = decode_attention(q, cache.k, cache.v, cache.slot_pos, pos,
                             window=window, cap=cfg.attn_softcap)
    return _out_proj(o.reshape(B, S, -1), p), cache
