"""Int8 KV-cache quantization: symmetric int8 per (position, head) vector
with a float16 scale (the serving slice's KV-memory option).

Mirrors ``repro/serve/kv_quant.py`` (``quantize``, ``dequantize``,
``QuantizedKVCache``, ``init_quant_cache``, ``append``,
``decode_attention_quant``, ``cache_bytes``), with the same rounding
order: the absmax / 127 scale in
float32 (at least 1e-8), values divided by that float32 scale, rounded
half to even and clipped to [-127, 127]; the scale stored as float16 and
dequantization by the float16 scale.  The paged cache applies it at write
time (``serve/paged_cache.py``); the decode kernel applies the scales to
scores and probabilities and never dequantizes a page.  The dense
``QuantizedKVCache`` is the int8 counterpart of ``models/attention.py``'s
rolling ``KVCache``: ``append`` quantizes one token's k/v into slot
``pos % C`` (in place, and returns the cache) and
``decode_attention_quant`` applies the scales to the scores and the
probabilities, never dequantizing the cache (plain PyTorch, as the
reference's plain jnp).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class QuantizedKVCache(NamedTuple):
    k_q: torch.Tensor        # int8 (B, C, Hkv, Dh)
    k_scale: torch.Tensor    # float16 (B, C, Hkv, 1)
    v_q: torch.Tensor        # int8 (B, C, Hkv, Dh)
    v_scale: torch.Tensor    # float16 (B, C, Hkv, 1)
    slot_pos: torch.Tensor   # int32 (B, C), per request (-1 empty)


def quantize(x: torch.Tensor):
    """Symmetric int8 over the last axis.  x: (..., D) -> (int8 (..., D),
    float16 scales (..., 1))."""
    xf = x.float()
    absmax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(absmax / 127.0, min=1e-8)
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return q.to(torch.int8), scale.to(torch.float16)


def dequantize(q: torch.Tensor, scale: torch.Tensor,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return (q.float() * scale.float()).to(dtype)


def init_quant_cache(batch: int, capacity: int, n_kv: int, head_dim: int,
                     device=None) -> QuantizedKVCache:
    shape = (batch, capacity, n_kv)
    return QuantizedKVCache(
        k_q=torch.zeros(*shape, head_dim, dtype=torch.int8, device=device),
        k_scale=torch.zeros(*shape, 1, dtype=torch.float16, device=device),
        v_q=torch.zeros(*shape, head_dim, dtype=torch.int8, device=device),
        v_scale=torch.zeros(*shape, 1, dtype=torch.float16, device=device),
        slot_pos=torch.full((batch, capacity), -1, dtype=torch.int32,
                            device=device))


def append(cache: QuantizedKVCache, k: torch.Tensor, v: torch.Tensor,
           pos) -> QuantizedKVCache:
    """Write one token's k/v (B, Hkv, Dh) at absolute position ``pos``
    (scalar, or (B,) per request) into slot ``pos % C``, in place; returns
    the cache."""
    B, C = cache.slot_pos.shape
    pos = torch.as_tensor(pos, device=k.device).reshape(-1).expand(B)
    slot = (pos % C).long()
    bidx = torch.arange(B, device=k.device)
    kq, ks = quantize(k)
    vq, vs = quantize(v)
    cache.k_q[bidx, slot] = kq
    cache.k_scale[bidx, slot] = ks
    cache.v_q[bidx, slot] = vq
    cache.v_scale[bidx, slot] = vs
    cache.slot_pos[bidx, slot] = pos.to(torch.int32)
    return cache


def decode_attention_quant(q: torch.Tensor, cache: QuantizedKVCache, pos, *,
                           window: int = 0,
                           cap: float = 0.0) -> torch.Tensor:
    """One-token attention against the int8 cache.  q: (B, 1, Hq, Dh).
    Scores are (q . k_q) k_scale in float32 and the probabilities are
    scaled by v_scale before the product with v_q."""
    B, _, Hq, Dh = q.shape
    Hkv = cache.k_q.shape[2]
    G = Hq // Hkv
    pos = torch.as_tensor(pos, device=q.device).reshape(-1).expand(B)
    qf = (q.reshape(B, Hkv, G, Dh) * Dh ** -0.5).float()
    s = torch.einsum("bhgd,bchd->bhgc", qf, cache.k_q.float())
    s = s * cache.k_scale[..., 0].float().transpose(1, 2)[:, :, None, :]
    if cap:
        s = cap * torch.tanh(s / cap)
    valid = (cache.slot_pos >= 0) & (cache.slot_pos <= pos[:, None])
    if window:
        valid &= cache.slot_pos > pos[:, None] - window
    s = torch.where(valid[:, None, None, :], s, s.new_tensor(-1e30))
    p = torch.softmax(s, dim=-1)
    pv = p * cache.v_scale[..., 0].float().transpose(1, 2)[:, :, None, :]
    out = torch.einsum("bhgc,bchd->bhgd", pv, cache.v_q.float())
    return out.reshape(B, 1, Hq, Dh).to(q.dtype)


def cache_bytes(cache) -> int:
    """Bytes of every tensor in ``cache``: a tensor, or nested lists and
    tuples of tensors (a list of ``PagedKV`` pools, a
    ``QuantizedKVCache``, ``init_cache``'s list); ``None`` counts 0."""
    if cache is None:
        return 0
    if isinstance(cache, torch.Tensor):
        return cache.numel() * cache.element_size()
    return sum(cache_bytes(c) for c in cache)
