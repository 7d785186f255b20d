"""Temperature sampling with per-request noise.

The reference samples each row with ``jax.random.categorical(key, logits /
T)`` under ``key = fold_in(fold_in(seed, rid), token_index)``
(``repro/serve/engine.py:_sample_traced``): a request's tokens depend only
on the seed, its id and the token's index, never on the batch, the slot or
the schedule.  That is what makes the async runtime token-identical to the
synchronous engine.  PyTorch cannot reproduce JAX's threefry stream, so the
port keeps the property with its own noise: ``categorical`` is
``argmax(logits / T + g)`` with Gumbel noise ``g``, and here ``g`` comes
from a counter-based integer hash of ``(seed, rid, token index, vocab
index)``.

The hash is murmur3's 32-bit finalizer.  A row's key (:func:`row_keys`,
from the seed, the rid and the token index) is hashed on the host, where
the scheduler holds rid and index, and crosses to the device with the
step's other inputs; the device hashes the key with each vocabulary index
(:func:`noise_from_keys`) in int64 tensor ops whose products stay below
2^49 (a 32-bit value times a constant split into 16-bit halves), so no op
overflows the signed 64-bit range, and integer ops give the same bits on
the CPU and the card.  The uniform draw has 24 bits and the double
logarithm runs in float64 before the cast to float32, so the noise agrees
bit for bit between the two devices (a per-row ``torch.Generator`` would
not: mt19937 on the CPU, Philox on the card).

:func:`sample` is a function of ``(logits, noise, T)`` so that a test can
feed it JAX's own Gumbel noise.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_C1, _C2 = 0x85EBCA6B, 0xC2B2AE35      # murmur3's finalizer constants


def _fmix32_host(x: np.ndarray) -> np.ndarray:
    """murmur3's 32-bit finalizer on uint64 numpy values below 2^32 (the
    products wrap modulo 2^64, and only their low 32 bits are kept)."""
    x = x ^ (x >> np.uint64(16))
    x = (x * np.uint64(_C1)) & np.uint64(_M32)
    x = x ^ (x >> np.uint64(13))
    x = (x * np.uint64(_C2)) & np.uint64(_M32)
    return x ^ (x >> np.uint64(16))


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2^32`` for int64 ``x`` in [0, 2^32) and ``c < 2^32``:
    ``x * c_lo + ((x * c_hi) mod 2^16) * 2^16`` with ``c``'s 16-bit halves,
    every intermediate below 2^49."""
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (x * (c & 0xFFFF) + hi) & _M32


def _fmix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3's 32-bit finalizer on int64 tensors in [0, 2^32)."""
    x = x ^ (x >> 16)
    x = _mul32(x, _C1)
    x = x ^ (x >> 13)
    x = _mul32(x, _C2)
    return x ^ (x >> 16)


def row_keys(seed: int, rid, index) -> np.ndarray:
    """Keys in [0, 2^32) of ``(seed, request id, token index)``, one a row
    (host arrays in, an int64 array out)."""
    rid = np.asarray(rid).astype(np.int64).astype(np.uint64) & np.uint64(_M32)
    idx = np.asarray(index).astype(np.int64).astype(np.uint64) & np.uint64(
        _M32)
    k = _fmix32_host(np.full(rid.shape, (seed ^ 0x243F6A88) & _M32,
                             np.uint64))
    k = _fmix32_host(k ^ rid)
    return _fmix32_host(k ^ idx).astype(np.int64)


@functools.lru_cache(maxsize=8)
def _vocab_mix(vocab: int, device: torch.device) -> torch.Tensor:
    """The hashed vocabulary indices, once per (vocabulary, device)."""
    v = torch.arange(vocab, dtype=torch.int64, device=device)
    return _fmix32(v ^ 0x6A09E667)


def uniform_bits(keys: torch.Tensor, vocab: int) -> torch.Tensor:
    """(B, vocab) int64 hashes in [0, 2^32) of (B,) row keys (any integer
    tensor holding the keys' low 32 bits) and each vocabulary index."""
    k = keys.long() & _M32
    return _fmix32(k[:, None] ^ _vocab_mix(vocab, keys.device)[None, :])


def noise_from_keys(keys: torch.Tensor, vocab: int) -> torch.Tensor:
    """(B, vocab) float32 Gumbel noise ``-log(-log(u))`` with ``u = (m +
    1/2) / 2^24`` from the top 24 bits ``m`` of each hash (exact in
    float64, strictly inside (0, 1))."""
    u = (uniform_bits(keys, vocab) >> 8).double().add_(0.5).mul_(2.0 ** -24)
    return u.log_().neg_().log_().neg_().float()


def gumbel_noise(seed: int, rid, index, vocab: int,
                 device=None) -> torch.Tensor:
    """The noise of rows ``(seed, rid, index)`` (host arrays or tensors;
    the keys are hashed on the host) on ``device`` (default: ``rid``'s)."""
    if device is None:
        device = rid.device if isinstance(rid, torch.Tensor) else "cpu"
    host = lambda a: a.cpu().numpy() if isinstance(a, torch.Tensor) else a
    keys = torch.from_numpy(row_keys(seed, host(rid), host(index)))
    return noise_from_keys(keys.to(device), vocab)


def sample_scores(logits: torch.Tensor, noise: torch.Tensor,
                  temperature: float) -> torch.Tensor:
    """``logits / T + noise``.  The division is by a tensor, so both
    devices divide (a CUDA division by a host scalar multiplies by its
    reciprocal instead)."""
    return logits / torch.full_like(logits, temperature) + noise


def sample(logits: torch.Tensor, noise: torch.Tensor,
           temperature: float) -> torch.Tensor:
    """``argmax(logits / T + noise)`` over the last axis: the Gumbel-max
    form of ``categorical(logits / T)``."""
    return torch.argmax(sample_scores(logits, noise, temperature), dim=-1)
