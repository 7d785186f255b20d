"""Flash-attention forward: CUDA kernel, its plain version, and the
differentiable wrapper of the training path.

Replaces ``repro/kernels/flash_attention.py:flash_attention_pallas``
(kernel ``_kernel``) and mirrors ``flash_attention_fused`` around it.
Causal, sliding-window and softcapped GQA attention: q (B, S, H, Dh),
k and v (B, S, Hkv, Dh); float32 scores scaled by ``Dh**-0.5``, float32
online softmax, P rounded to v's dtype for P·V, float32 accumulation,
output ``acc / max(l, 1e-30)`` in ``q.dtype``.

Bound on the card: operations (4·B·S²·H·Dh/2 for causal attention).
``csrc/flash_attention.cu`` runs one block per (batch·head, query tile)
that walks its kv tiles in a loop, instead of the TPU's kv grid axis
carried across steps, and reads the group's kv head in place instead of
repeating it.  It has two kernels, and :func:`tensor_core_path` chooses:

- tensor cores, for bf16 at any head width up to 128 that is a multiple
  of 8, with 16-byte aligned tensors: TMA tiles cut from the
  ``(B, S, H, Dh)`` layout, padded with zero columns to 64 or 128, feed
  ``wgmma`` for Q·Kᵀ and for P·V (P in registers);
- general, for float32 at any width and for the bf16 calls the tensor
  cores cannot take (Dh off the multiple of 8 or above 128, a pointer off
  16 bytes): K and V tiles staged in shared memory as float32 and
  register-tiled float32 FMAs, with the same online softmax and P rounded
  to v's dtype.

The plain version, :func:`flash_attention_plain`, is the chunked
online-softmax attention of ``repro/models/attention.py:flash_attention``;
it also serves the port's plain prefill attention.  As in the reference,
the backward is not a kernel: :class:`FlashAttention` recomputes through
the plain version under autograd (``_fa_bwd``).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _lib, cost
from repro_torch.models.common import softcap

NEG_INF = -1e30


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int = 0,
                          cap: float = 0.0, q_offset: int = 0,
                          chunk: int = 512) -> torch.Tensor:
    """Chunked online-softmax attention in float32.

    q: (B, Sq, Hq, Dh); k, v: (B, Skv, Hkv, Dh), Hq % Hkv == 0.
    ``window > 0`` restricts to a causal sliding window.  KV chunks that
    are fully masked for every query contribute nothing and are skipped
    (the reference's ``block_skip``; the same result).  With
    ``q_offset = 0`` and ``Sq == Skv`` no chunk is masked for every query,
    so every chunk is computed, as with the reference's
    ``block_skip=False``."""
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


#: the widest head the tensor-core kernel takes (its padded width)
TENSOR_CORE_MAX_DH = 128


def tensor_core_path(q: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor) -> bool:
    """Whether the kernel call takes the tensor cores (bf16, a head width
    that is a multiple of 8 up to :data:`TENSOR_CORE_MAX_DH`, q, k and v
    16-byte aligned) rather than the general kernel.  The one place the
    path is chosen: :func:`flash_attention` passes it to
    ``csrc/flash_attention.cu``, which refuses the tensor cores for inputs
    they cannot take."""
    Dh = q.shape[-1]
    return (q.dtype == torch.bfloat16 and Dh % 8 == 0
            and Dh <= TENSOR_CORE_MAX_DH
            and all(_lib.aligned16(t) for t in (q, k, v)))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    cap: float = 0.0) -> torch.Tensor:
    """Forward of ``flash_attention_pallas``: q (B, S, H, Dh), k and v
    (B, S, Hkv, Dh) -> (B, S, H, Dh).  A CPU tensor takes the plain
    version (in the TPU kernel's ``min(128, S)`` tiles); a CUDA tensor
    launches the kernel of :func:`tensor_core_path`'s choice (counted in
    ``flash_attention.launches``, the general kernel's launches also in
    ``flash_attention.general_launches``)."""
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     cap=cap, chunk=min(128, k.shape[1]))
    dt = q.dtype
    if dt not in _lib.DTYPE_CODE:
        raise ValueError(f"flash_attention takes float32 or bfloat16, "
                         f"got {dt}")
    _lib.require(q, "q", dtype=dt, ndim=4)
    _lib.require(k, "k", dtype=dt, ndim=4, device=q.device)
    _lib.require(v, "v", dtype=dt, ndim=4, device=q.device)
    B, S, H, Dh = q.shape
    if (k.shape != v.shape or k.shape[0] != B or k.shape[1] != S
            or k.shape[3] != Dh or H % k.shape[2]):
        raise ValueError(f"bad shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if Dh > 256:
        raise ValueError(f"head width {Dh} > 256")
    tensor_cores = tensor_core_path(q, k, v)
    out = torch.empty_like(q)
    if _lib.dry("flash_attention",
                cost.flash_attention(B, S, H, Dh, causal, window),
                (q, k, v), (out,)):
        return out
    code = _lib.lib().repro_flash_attention(
        _lib.DTYPE_CODE[dt], int(tensor_cores), q.data_ptr(), k.data_ptr(),
        v.data_ptr(), out.data_ptr(), B, S, H, k.shape[2], Dh, int(causal),
        int(window), float(cap), float(Dh ** -0.5), _lib.stream_ptr(q))
    _lib.check("repro_flash_attention", code)
    flash_attention.launches += 1
    if not tensor_cores:
        flash_attention.general_launches += 1
    return out


flash_attention.launches = 0
flash_attention.general_launches = 0


class FlashAttention(torch.autograd.Function):
    """``flash_attention_fused``: the kernel forward; the backward is
    autograd through the plain chunked attention with
    ``chunk = min(512, S)``, recomputed from q, k and v (``_fa_bwd``), so
    no score matrix is saved."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int, cap: float):
        ctx.save_for_backward(q, k, v)
        ctx.opts = (causal, window, cap)
        return flash_attention(q, k, v, causal=causal, window=window,
                               cap=cap)

    @staticmethod
    def backward(ctx, do):
        causal, window, cap = ctx.opts
        q, k, v = (t.detach().requires_grad_() for t in ctx.saved_tensors)
        with torch.enable_grad():
            out = flash_attention_plain(q, k, v, causal=causal,
                                        window=window, cap=cap,
                                        chunk=min(512, q.shape[1]))
            dq, dk, dv = torch.autograd.grad(out, (q, k, v), do)
        return dq, dk, dv, None, None, None


def flash_attention_fused(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True, window: int = 0,
                          cap: float = 0.0) -> torch.Tensor:
    """Differentiable flash attention (``flash_attention_fused``)."""
    return FlashAttention.apply(q, k, v, causal, window, cap)
