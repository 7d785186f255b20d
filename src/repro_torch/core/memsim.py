"""Capacity arithmetic of the ``ep_a2a`` exchanges.

A copy of the three helpers of ``repro/core/memsim.py`` that the
distributed MoE path needs: the per-destination slot capacity of one
exchange hop and the row counts of the flat and the two-hop buffers.  The
rest of the reference's memory simulator (the per-device peak model and
the budget fit) is not ported (ROADMAP.md §A item 2).
"""

from __future__ import annotations


def _a2a_capacity(cfg, slots: int, n: int, clamp: int | None = None) -> int:
    """Per-destination slot capacity of one a2a hop over ``n`` ranks: the
    uniform share of ``slots`` scaled by ``cfg.moe_a2a_capacity``,
    clamped to ``[1, clamp or slots]``."""
    n = max(n, 1)
    uniform = (slots + n - 1) // n
    cap = int(uniform * float(cfg.moe_a2a_capacity))
    return max(min(cap, clamp if clamp is not None else slots), 1)


def _a2a_rows(cfg, n_tokens: int, n_model: int) -> int:
    """Rows of the flat ``ep_a2a`` send/receive buffers on one rank:
    ``n_model * C`` on the ``L / n_model`` token chunk, with C rounded up
    to a multiple of ``cfg.moe_a2a_chunks`` as the chunked path pads it."""
    n = max(n_model, 1)
    chunk = max(n_tokens // n, 1)
    c = _a2a_capacity(cfg, chunk * cfg.top_k, n)
    ch = max(int(getattr(cfg, "moe_a2a_chunks", 1)), 1)
    if ch > 1:
        c = -(-c // ch) * ch
    return n * c


def _a2a_hier_rows(cfg, n_tokens: int, n_node: int, n_lane: int
                   ) -> tuple[int, int]:
    """(hop-1 rows, hop-2 rows) of the two-hop ``ep_a2a_hier`` buffers:
    hop 1 groups the ``L / n`` chunk's slots by destination lane over the
    ``n_lane`` ranks of a node, hop 2 regroups the received rows by
    destination node over ``n_node`` ranks."""
    n = max(n_node, 1) * max(n_lane, 1)
    chunk = max(n_tokens // n, 1)
    slots = chunk * cfg.top_k
    c1 = _a2a_capacity(cfg, slots, n_lane)
    r1 = max(n_lane, 1) * c1
    c2 = _a2a_capacity(cfg, slots, n_node, clamp=r1)
    return r1, max(n_node, 1) * c2
