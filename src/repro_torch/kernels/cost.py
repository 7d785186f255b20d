"""The operations each kernel call does, from its shapes: the formulas of
the kernels' bounds (``PERF.md`` §6, ``chip_smoke.py``'s ``bound_ms``
rows), kept in one place for the dry run (``_lib.dry_run``), which
records them beside each call's bytes (every input read and every output
written once).

The dry run sees shapes, not data, so a grouped GEMM counts every slot
row as routed: on an expert-parallel rank the slots of other ranks'
experts sit in the dead zone, where the kernels write zeros without
multiplying, so the count is an upper bound there.
"""

from __future__ import annotations


def grouped_gemm(S: int, d: int, h: int, weights: int = 1) -> float:
    """A gather-GMM or ``gmm_dw`` call: 2·S·d·h for each weight."""
    return 2.0 * S * d * h * weights


def fused_swiglu(L: int, d: int, h: int) -> float:
    """A fused SwiGLU kernel (forward, ``bwd_x`` or ``bwd_w``): two
    (L, d) x (d, h) products, 4·L·d·h."""
    return 4.0 * L * d * h


def fused_moe(S: int, d: int, h: int, backward: bool) -> float:
    """The fused MoE pair: the forward's three products, 6·S·d·h; the
    backward's recomputed a and b, dyu, dw1, dw2, dw3 and dx, 16·S·d·h."""
    return (16.0 if backward else 6.0) * S * d * h


def attention_pairs(S: int, causal: bool, window: int) -> int:
    """Live (query, key) pairs of one head over S positions: every pair
    bidirectionally, else each query's keys at or before it and, with a
    window, fewer than ``window`` positions back."""
    if not causal:
        return S * S
    if window and window < S:
        return window * (window + 1) // 2 + (S - window) * window
    return S * (S + 1) // 2


def flash_attention(B: int, S: int, H: int, Dh: int, causal: bool,
                    window: int) -> float:
    """The flash-attention forward: 4·Dh operations (QKᵀ and PV) for each
    live (query, key) pair of each of B·H heads."""
    return 4.0 * B * H * Dh * attention_pairs(S, causal, window)


def paged_attention(B: int, Hq: int, Dh: int, positions: int) -> float:
    """A decode call over paged KV: 4·Dh operations for each query head
    and each of ``positions`` cached positions (the table's whole span:
    the positions a request has reached are data)."""
    return 4.0 * B * Hq * Dh * positions


def combine(L: int, k: int, d: int) -> float:
    """The gate-weighted sum: a product and a sum for each of L·k·d
    terms."""
    return 2.0 * L * k * d
