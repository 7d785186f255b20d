"""Model assembly for paged serving: embeddings, the attention + MoE
sublayers, and the prefill / decode entry points.

Mirrors ``repro/models/transformer.py`` (``_apply_sublayer`` for the
``attn_moe`` / ``attn_local_moe`` kinds, ``init_paged_cache``, ``prefill``
without prefix offsets, ``paged_decode_step``).  Layers run in a Python
loop where the reference scans over stacked groups; ``params["layers"]`` is
a list with one dict per layer (see ``repro_torch.interop``).  The KV pools
are updated in place.
"""

from __future__ import annotations

import torch

from repro_torch.models.attention import paged_attention_sublayer
from repro_torch.models.common import rms_norm, softcap
from repro_torch.models.moe_block import moe_sublayer
from repro_torch.serve.paged_cache import init_paged_kv

SERVE_KINDS = ("attn_moe", "attn_local_moe")


def layer_kinds(cfg) -> list[str]:
    """Block kind of each layer (the pattern repeated over groups)."""
    return [cfg.block_pattern[i % cfg.pattern_period]
            for i in range(cfg.num_layers)]


def check_supported(cfg) -> None:
    bad = sorted(set(cfg.block_pattern) - set(SERVE_KINDS))
    if bad:
        raise NotImplementedError(
            f"block kinds {bad} are not ported; the serving slice runs "
            f"{SERVE_KINDS} (ROADMAP queue A)")
    if cfg.input_kind != "tokens":
        raise NotImplementedError("the port serves token inputs only")


def _apply_sublayer(x, p, kind: str, cfg, *, positions, pages, page_table,
                    prefill: bool):
    is_local = "local" in kind and cfg.sliding_window > 0
    h = paged_attention_sublayer(
        rms_norm(x, p["ln1"]), p["attn"], cfg, is_local=is_local,
        positions=positions, pages=pages, page_table=page_table,
        prefill=prefill)
    if cfg.post_norms:
        h = rms_norm(h, p["ln1_post"])
    x = x + h
    h = moe_sublayer(rms_norm(x, p["ln2"]), p["moe"], cfg)
    if cfg.post_norms:
        h = rms_norm(h, p["ln2_post"])
    return x + h


def init_paged_cache(cfg, num_pages: int, page_size: int, device):
    """One :class:`~repro_torch.serve.paged_cache.PagedKV` pool per layer
    (physical page 0 is the trash page), in the model dtype."""
    check_supported(cfg)
    dt = getattr(torch, cfg.dtype)
    return [init_paged_kv(num_pages, page_size, cfg.num_kv_heads,
                          cfg.resolved_head_dim, dt, device)
            for _ in range(cfg.num_layers)]


def _embed(params, tokens, cfg):
    return params["embed"][tokens.long()] * (cfg.d_model ** 0.5)


def _logits(params, x, cfg):
    x = rms_norm(x, params["final_norm"])
    return softcap((x @ params["unembed"]).float(), cfg.final_softcap)


def _layers(params, x, cfg, *, positions, cache, page_table, prefill):
    for p, kind, pages in zip(params["layers"], layer_kinds(cfg), cache):
        x = _apply_sublayer(x, p, kind, cfg, positions=positions,
                            pages=pages, page_table=page_table,
                            prefill=prefill)
    return x


def prefill(params, tokens, lengths, cache, page_table, cfg):
    """Whole-prompt forward that fills the paged cache in one call.

    tokens: (B, S) right-padded prompts; lengths: (B,) true lengths;
    page_table: (B, pages_per_seq) int32.  Every position is written through
    the page table (pad tails land on the trash page or in slots that decode
    overwrites before reading).  Returns float32 logits (B, vocab) at each
    request's last prompt token."""
    check_supported(cfg)
    B, S = tokens.shape
    x = _embed(params, tokens, cfg)
    positions = torch.arange(S, device=x.device)
    x = _layers(params, x, cfg, positions=positions, cache=cache,
                page_table=page_table, prefill=True)
    idx = torch.clamp(lengths.long() - 1, 0, S - 1)
    x_last = x[torch.arange(B, device=x.device), idx]
    return _logits(params, x_last, cfg)


def paged_decode_step(params, cache, tokens, lengths, page_table, cfg):
    """One decode step with every request at its own position.

    tokens: (B, 1) last token per request; lengths: (B,) int32 position the
    token is written at.  Returns float32 logits (B, vocab)."""
    check_supported(cfg)
    x = _embed(params, tokens, cfg)
    x = _layers(params, x, cfg, positions=lengths, cache=cache,
                page_table=page_table, prefill=False)
    return _logits(params, x[:, 0], cfg)
