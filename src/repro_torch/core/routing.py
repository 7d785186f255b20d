"""Gating and the MoEBlaze dispatch structures (paper §2.1, §4).

The four index structures (paper §4.1), as in ``repro/core/routing.py``:

  expert_token_indices : (L*k,) int32 — token ids grouped by expert, within a
      group ordered by token id; expert ``e`` owns
      ``[expert_token_offsets[e], expert_token_offsets[e+1])``.
  expert_token_offsets : (E+1,) int32 — exclusive prefix sums of counts.
  token_expert_indices : (L*k,) int32 — chosen expert ids in token order.
  token_index_map      : (L, k) int32 — each token's k slot positions inside
      ``expert_token_indices`` (the inverse permutation; the combine gathers
      through it).

:func:`build_dispatch` here is the plain PyTorch rendering of the sort-free
build; ``kernels/dispatch.py`` holds the CUDA kernel that produces the same
integers bit for bit.  :func:`build_dispatch_sort` is the sort-based build
the paper compares against (§4.2), with the same integers.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Dispatch(NamedTuple):
    """The MoEBlaze routing metadata (paper Fig. 2)."""

    expert_token_indices: torch.Tensor  # (L*k,) int32
    expert_token_offsets: torch.Tensor  # (E+1,) int32
    token_expert_indices: torch.Tensor  # (L*k,) int32
    token_index_map: torch.Tensor       # (L, k) int32
    expert_lengths: torch.Tensor        # (E,)   int32

    @property
    def num_slots(self) -> int:
        return self.expert_token_indices.shape[0]


class GatingOut(NamedTuple):
    topk_experts: torch.Tensor  # (L, k) int32
    topk_weights: torch.Tensor  # (L, k) float32, renormalized
    router_probs: torch.Tensor  # (L, E) float32
    logits: torch.Tensor        # (L, E) float32


def top_k_gating(x: torch.Tensor, w_gate: torch.Tensor, k: int,
                 *, renormalize: bool = True) -> GatingOut:
    """``TopK(softmax(W_g x))`` with float32 logits.  x: (L, d);
    w_gate: (d, E)."""
    logits = x.float() @ w_gate.float()
    probs = torch.softmax(logits, dim=-1)
    topk_weights, topk_experts = torch.topk(probs, k, dim=-1)
    if renormalize:
        topk_weights = topk_weights / topk_weights.sum(-1, keepdim=True)
    return GatingOut(topk_experts.to(torch.int32), topk_weights, probs, logits)


def load_balance_loss(router_probs: torch.Tensor, topk_experts: torch.Tensor,
                      num_experts: int) -> torch.Tensor:
    """Switch/Mixtral-style auxiliary load-balance loss."""
    L, k = topk_experts.shape
    assign = torch.nn.functional.one_hot(topk_experts.long(),
                                         num_experts).float()   # (L, k, E)
    frac_tokens = assign.sum(dim=(0, 1)) / (L * k)
    frac_probs = router_probs.mean(dim=0)
    return num_experts * torch.sum(frac_tokens * frac_probs)


def router_z_loss(logits: torch.Tensor) -> torch.Tensor:
    """ST-MoE z-loss: penalizes large router logits for stability."""
    return torch.mean(torch.logsumexp(logits, dim=-1) ** 2)


def build_dispatch(topk_experts: torch.Tensor, num_experts: int) -> Dispatch:
    """Sort-free dispatch build in plain PyTorch (one-hot map, column sums,
    exclusive scans).  The reference for the CUDA kernel."""
    L, k = topk_experts.shape
    n = L * k
    dev = topk_experts.device
    flat = topk_experts.reshape(n).long()
    onehot = torch.nn.functional.one_hot(flat, num_experts)      # (n, E)
    lengths = onehot.sum(dim=0)
    offsets = torch.cat([torch.zeros(1, dtype=lengths.dtype, device=dev),
                         torch.cumsum(lengths, 0)])
    ranks_all = torch.cumsum(onehot, dim=0) - onehot
    rank = torch.gather(ranks_all, 1, flat[:, None])[:, 0]
    dest = offsets[flat] + rank                                  # (n,)
    token_ids = torch.arange(n, device=dev) // k
    eti = torch.zeros(n, dtype=torch.long, device=dev)
    eti[dest] = token_ids
    i32 = torch.int32
    return Dispatch(
        expert_token_indices=eti.to(i32),
        expert_token_offsets=offsets.to(i32),
        token_expert_indices=flat.to(i32),
        token_index_map=dest.reshape(L, k).to(i32),
        expert_lengths=lengths.to(i32),
    )


def build_dispatch_sort(topk_experts: torch.Tensor,
                        num_experts: int) -> Dispatch:
    """Sort-based build (paper §4.2's strawman), as the reference's
    ``build_dispatch_sort``: a stable sort of the slots by expert id, then
    index recovery by a scatter.  The same integers as
    :func:`build_dispatch`; plain PyTorch, several calls on the card."""
    L, k = topk_experts.shape
    n = L * k
    dev = topk_experts.device
    flat = topk_experts.reshape(n).to(torch.int32)
    order = torch.sort(flat, stable=True).indices
    slots = torch.arange(n, device=dev)
    dest = torch.empty(n, dtype=torch.long, device=dev)
    dest[order] = slots
    lengths = torch.bincount(flat, minlength=num_experts)[:num_experts]
    offsets = torch.cat([lengths.new_zeros(1), torch.cumsum(lengths, 0)])
    i32 = torch.int32
    return Dispatch(
        expert_token_indices=(order // k).to(i32),
        expert_token_offsets=offsets.to(i32),
        token_expert_indices=flat,
        token_index_map=dest.reshape(L, k).to(i32),
        expert_lengths=lengths.to(i32),
    )


def slice_dispatch(d: Dispatch, e_lo, e_hi=None, *,
                   count: int | None = None) -> Dispatch:
    """Compact a global :class:`Dispatch` to the expert range ``[e_lo,
    e_hi)`` (the device-local view under expert parallelism), as the
    reference's ``routing.slice_dispatch``.

    The slot axis is rotated by ``offsets[e_lo]`` modulo ``L*k``, a
    bijection: the local experts' slots land at ``[0, n_loc)`` in expert
    order, every other slot lands once in the dead zone ``[n_loc, L*k)``,
    where a grouped GEMM over the rebased ``expert_lengths`` writes zeros.
    Offsets and lengths are rebased to the range; ``token_expert_indices``
    is shifted by ``-e_lo`` (values outside ``[0, count)`` mark non-local
    slots).  ``e_lo`` may be a Python int or a 0-d tensor; the local
    expert ``count`` is a Python int (pass it when ``e_hi`` is omitted).
    The rotation is index arithmetic on the dispatch's own tensors, so on
    the card it runs on the dispatch kernel's output."""
    if count is None:
        count = int(e_hi) - int(e_lo)
    if count <= 0:
        raise ValueError(f"empty expert range [{e_lo}, {e_hi})")
    off_all = d.expert_token_offsets
    dev = off_all.device
    e_lo = torch.as_tensor(e_lo, device=dev).long()
    rng = e_lo + torch.arange(count + 1, device=dev)
    off = off_all[rng]
    lens = d.expert_lengths[rng[:-1]]
    start = off[0].long()
    S = d.num_slots
    src = (torch.arange(S, device=dev) + start) % S
    i32 = torch.int32
    return Dispatch(
        expert_token_indices=d.expert_token_indices[src],
        expert_token_offsets=(off - off[0]).to(i32),
        token_expert_indices=(d.token_expert_indices - e_lo).to(i32),
        token_index_map=((d.token_index_map.long() - start) % S).to(i32),
        expert_lengths=lens.to(i32),
    )
