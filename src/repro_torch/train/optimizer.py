"""AdamW + cosine schedule + global-norm clipping.

Mirrors ``repro/train/optimizer.py``: the moments are float32 and
congruent with the parameter tree; weight decay applies to every leaf.
Where the reference builds new trees, the port updates the parameters,
gradients and moments in place, leaf by leaf, so a step at full width
holds one leaf's temporaries at a time instead of a second copy of the
model (plain PyTorch ops; AdamW is no Pallas kernel in the reference).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.core.collectives import all_reduce_


def tree_leaves(tree) -> list[torch.Tensor]:
    """Leaves of a nested dict / list of tensors, in a fixed order."""
    if isinstance(tree, dict):
        return [t for k in tree for t in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tree_leaves(v)]
    return [tree]


@dataclass
class AdamWState:
    step: int
    mu: list[torch.Tensor]      # float32, one per parameter leaf
    nu: list[torch.Tensor]


def init_adamw(params) -> AdamWState:
    zeros = [torch.zeros_like(p, dtype=torch.float32)
             for p in tree_leaves(params)]
    return AdamWState(step=0, mu=zeros,
                      nu=[torch.zeros_like(z) for z in zeros])


def cosine_schedule(step: int, *, peak_lr: float, warmup: int, total: int,
                    min_ratio: float = 0.1) -> float:
    """Linear warmup from 0, then cosine decay to ``min_ratio * peak``."""
    if step < warmup:
        return peak_lr * step / max(warmup, 1)
    frac = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
    return peak_lr * (min_ratio + (1 - min_ratio)
                      * 0.5 * (1 + math.cos(math.pi * frac)))


def global_norm(grads: list[torch.Tensor], *, sharded=None,
                group=None) -> torch.Tensor:
    """The norm of all gradient leaves.  With ``sharded`` (one flag per
    leaf) and ``group``, the flagged leaves are this rank's shards of
    leaves split over ``group``: their squares are summed over the group,
    so each shard counts once, and every other leaf counts once."""
    sq = lambda gs: sum((g.float().square().sum() for g in gs),
                        torch.zeros((), device=grads[0].device))
    if sharded is None:
        return torch.sqrt(sq(grads))
    local = sq(g for g, s in zip(grads, sharded) if s)
    rest = sq(g for g, s in zip(grads, sharded) if not s)
    return torch.sqrt(rest + all_reduce_(local, group))


def clip_by_global_norm(grads: list[torch.Tensor], max_norm: float, *,
                        sharded=None, group=None) -> torch.Tensor:
    """Scales ``grads`` in place to a global norm of at most ``max_norm``;
    returns the norm before clipping (``sharded`` and ``group`` as in
    :func:`global_norm`)."""
    norm = global_norm(grads, sharded=sharded, group=group)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    for g in grads:
        g.mul_(scale.to(g.dtype))
    return norm


@torch.no_grad()
def adamw_update(grads: list[torch.Tensor], state: AdamWState,
                 params: list[torch.Tensor], *, lr: float, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1) -> AdamWState:
    """One AdamW step over the parameter leaves, in place (the parameters
    and moments are overwritten; ``grads`` are read)."""
    step = state.step + 1
    c1, c2 = 1 - b1 ** step, 1 - b2 ** step
    for g, m, v, p in zip(grads, state.mu, state.nu, params):
        g = g.float()
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        delta = m / c1
        delta.div_((v / c2).sqrt_().add_(eps))
        delta.add_(p.float(), alpha=weight_decay)
        if p.dtype == torch.float32:
            p.add_(delta, alpha=-lr)
        else:
            # the reference's (p.f32 - lr * delta).astype(p.dtype): one
            # rounding of the float32 update, not of delta first
            p.copy_(p.float() - lr * delta)
    state.step = step
    return state
