"""Int8 KV-cache quantization: symmetric int8 per (position, head) vector
with a float16 scale (the serving slice's KV-memory option).

Mirrors ``repro/serve/kv_quant.py`` (``quantize``, ``dequantize``,
``cache_bytes``), with the same rounding order: the absmax / 127 scale in
float32 (at least 1e-8), values divided by that float32 scale, rounded
half to even and clipped to [-127, 127]; the scale stored as float16 and
dequantization by the float16 scale.  The paged cache applies it at write
time (``serve/paged_cache.py``); the decode kernel applies the scales to
scores and probabilities and never dequantizes a page.  The dense
``QuantizedKVCache`` and its decode attention belong to the ``KVCache``
decode path, which the port does not have yet.
"""

from __future__ import annotations

import torch


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


def cache_bytes(cache) -> int:
    """Bytes of every tensor in ``cache``: a tensor, or nested lists and
    tuples of tensors (a list of ``PagedKV`` pools); ``None`` counts 0."""
    if cache is None:
        return 0
    if isinstance(cache, torch.Tensor):
        return cache.numel() * cache.element_size()
    return sum(cache_bytes(c) for c in cache)
