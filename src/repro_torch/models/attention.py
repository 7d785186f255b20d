"""Attention: GQA projections with RoPE, the full-sequence sublayer of
the training forward, and the paged attention sublayer of serving.

Mirrors ``repro/models/attention.py`` (``_project_qkv``,
``attention_sublayer`` without a ``KVCache``, ``paged_attention_sublayer``
with its prefix-sharing suffix branch).  Full-sequence attention is the
flash-attention kernel when ``cfg.use_pallas`` is set
(``flash_attention_fused``) and the plain chunked computation otherwise
(the reference computes it in plain JAX then); decode attention goes
through the paged-attention implementation ``attn_impl`` (the kernel by
default); the suffix prefill of prefix sharing attends over the request's
gathered pages in plain PyTorch, as the reference does in plain jnp.
Weights are cast to the activations' dtype on use, as in the reference.
The q projection and the output projection are the producers of the
checkpoint tags ``QKV`` and ``ATTN_OUT`` (``core/checkpoint.py:tagged``),
as the reference tags them.
"""

from __future__ import annotations

import torch

from repro_torch.core.checkpoint import ATTN_OUT, QKV, tagged
from repro_torch.kernels.flash_attention import (flash_attention_fused,
                                                 flash_attention_plain)
from repro_torch.models.common import rms_norm, rope
from repro_torch.serve import paged_cache as PC


def project_qkv(x: torch.Tensor, p: dict, cfg, positions: torch.Tensor):
    """q/k/v projection, optional qk-norm, RoPE.  ``positions`` may be an
    (S,) shared sequence, a (B,) per-request decode position (S == 1), or a
    (B, S) grid."""
    B, S, _ = x.shape
    H, Hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
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
                       positions: torch.Tensor,
                       cache=None) -> torch.Tensor:
    """(B, S, d) -> (B, S, d) over the whole sequence (training and
    full-sequence forward).  The reference's decode branch (a ``KVCache``)
    is not ported: serving decodes through the paged sublayer."""
    if cache is not None:
        raise NotImplementedError(
            "attention_sublayer with a KVCache (decode_attention) is not "
            "ported; serving decodes through paged_attention_sublayer "
            "(ROADMAP.md §A item 4: attention)")
    B, S, _ = x.shape
    window = cfg.sliding_window if is_local else 0
    q, k, v, _ = project_qkv(x, p, cfg, positions)
    o = _full_attention(q, k, v, cfg, causal=cfg.causal, window=window)
    return _out_proj(o.reshape(B, S, -1), p)
