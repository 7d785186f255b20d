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
integers bit for bit.
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
