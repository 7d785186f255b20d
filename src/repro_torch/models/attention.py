"""Attention for the serving slice: GQA projections with RoPE, the chunked
online-softmax attention for prefill, and the paged attention sublayer.

Mirrors ``repro/models/attention.py`` (``_project_qkv``,
``flash_attention``, ``paged_attention_sublayer``).  Prefill attention is
the plain chunked computation in PyTorch (the reference computes it in
plain JAX when ``use_pallas`` is off); decode attention goes through the
paged attention kernel.  ``use_pallas=True`` selects the fused flash
attention kernel, which is not ported yet and raises.
"""

from __future__ import annotations

import torch

from repro_torch.models.common import rms_norm, rope, softcap
from repro_torch.serve import paged_cache as PC

NEG_INF = -1e30


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, cap: float = 0.0,
                    q_offset: int = 0, chunk: int = 512) -> torch.Tensor:
    """Chunked online-softmax attention in float32.

    q: (B, Sq, Hq, Dh); k, v: (B, Skv, Hkv, Dh), Hq % Hkv == 0.
    ``window > 0`` restricts to a causal sliding window.  KV chunks that
    are fully masked for every query contribute nothing and are skipped
    (the reference's ``block_skip``; the same result)."""
    B, Sq, Hq, Dh = q.shape
    _, Skv, Hkv, _ = k.shape
    G = Hq // Hkv
    chunk = min(chunk, Skv)
    if Skv % chunk:
        raise ValueError(f"kv length {Skv} is not a multiple of chunk {chunk}")
    qf = (q.reshape(B, Sq, Hkv, G, Dh) * Dh ** -0.5).float()
    q_pos = q_offset + torch.arange(Sq, device=q.device)
    m = torch.full((B, Sq, Hkv, G), NEG_INF, device=q.device)
    l = torch.zeros((B, Sq, Hkv, G), device=q.device)
    acc = torch.zeros((B, Sq, Hkv, G, Dh), device=q.device)
    q_lo, q_hi = q_offset, q_offset + Sq - 1
    for j in range(Skv // chunk):
        k_lo, k_hi = j * chunk, (j + 1) * chunk - 1
        if causal and k_lo > q_hi:
            break
        if window and k_hi <= q_lo - window:
            continue
        kc = k[:, k_lo:k_hi + 1].float()
        vc = v[:, k_lo:k_hi + 1].float()
        s = softcap(torch.einsum("bqhgd,bkhd->bqhgk", qf, kc), cap)
        k_pos = torch.arange(k_lo, k_hi + 1, device=q.device)
        mask = torch.ones((Sq, chunk), dtype=torch.bool, device=q.device)
        if causal:
            mask &= k_pos[None, :] <= q_pos[:, None]
        if window:
            mask &= k_pos[None, :] > q_pos[:, None] - window
        s = torch.where(mask[None, :, None, None, :], s,
                        torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum("bqhgk,bkhd->bqhgd", p, vc)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(B, Sq, Hq, Dh).to(q.dtype)


def project_qkv(x: torch.Tensor, p: dict, cfg, positions: torch.Tensor):
    """q/k/v projection, optional qk-norm, RoPE.  ``positions`` may be an
    (S,) shared sequence, a (B,) per-request decode position (S == 1), or a
    (B, S) grid."""
    B, S, _ = x.shape
    H, Hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = (x @ p["wq"]).reshape(B, S, H, dh)
    k = (x @ p["wk"]).reshape(B, S, Hkv, dh)
    v = (x @ p["wv"]).reshape(B, S, Hkv, dh)
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
                             prefill: bool) -> torch.Tensor:
    """Attention sublayer against a block-paged cache; writes the new k/v
    into ``pages`` in place and returns ``(B, S, d)``.

    ``prefill=True``: ``x`` is the whole right-padded prompt with
    ``positions = arange(S)``; every position's k/v is scattered through
    ``page_table`` and attention is causal over the in-flight k/v.
    ``prefill=False``: S == 1, ``positions`` are the (B,) per-request write
    positions; the token's k/v is appended and attention walks the pages."""
    if cfg.use_pallas:
        raise NotImplementedError(
            "use_pallas=True selects the fused flash-attention kernel, which "
            "is not ported yet (ROADMAP queue B: flash_attention_pallas)")
    B, S, _ = x.shape
    window = cfg.sliding_window if is_local else 0
    q, k, v, _ = project_qkv(x, p, cfg, positions)
    if prefill:
        PC.write_prefill(pages, k, v, page_table)
        o = flash_attention(q, k, v, causal=True, window=window,
                            cap=cfg.attn_softcap,
                            chunk=min(cfg.attn_chunk, S))
    else:
        PC.write_decode(pages, k, v, page_table, positions)
        o = PC.paged_attention(q, pages, page_table, positions,
                               window=window, cap=cfg.attn_softcap)
    return o.reshape(B, S, -1) @ p["wo"]
