"""The collectives of the distributed MoE path, with ``shard_map``'s
gradient semantics.

The reference runs the MoE body per device inside ``shard_map`` and lets
JAX transpose its collectives.  The port runs one process per rank and
differentiates each rank's program with autograd, so each collective is an
autograd ``Function`` whose backward gives every rank its share of the
gradient of the one global loss:

  * :func:`all_to_all` — equal splits along dim 0; the exchange is its own
    inverse, so the backward is the same exchange of the gradient;
  * :func:`psum_partials` — sums per-rank partial outputs (all-reduce).
    The output is replicated and every rank backpropagates the same
    cotangent of its copy, so the backward is the identity;
  * :func:`enter_replicated` — marks where a replicated input enters a
    body whose per-rank gradients are partial: the identity forward, an
    all-reduce sum of the gradient backward;
  * :func:`pmean` — the mean over ranks; the backward scales by ``1/n``.

``torch.distributed.nn.functional.all_reduce`` is not used: its backward
sums the ``n`` identical cotangents of a replicated output, giving ``n``
times the gradient.

The transport follows the group's backend, ``dist.get_backend(group)``:
under NCCL the tensors stay on the card and the synchronous collectives
are ordered on the current stream; under gloo a CUDA tensor is copied to
host memory, exchanged there and copied back (ranks that share one card
exchange this way).
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def staged(t: torch.Tensor, group) -> bool:
    """True when ``t`` crosses ``group`` through host memory (a CUDA
    tensor over a gloo group)."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def transport(group, device: torch.device) -> str:
    """How tensors on ``device`` travel over ``group``, for run records."""
    backend = dist.get_backend(group)
    if device.type == "cuda" and backend == "gloo":
        return "gloo, staged through host memory"
    return backend


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """In-place sum over ``group`` (no gradient); returns ``t``."""
    if staged(t, group):
        host = t.cpu()
        dist.all_reduce(host, group=group)
        t.copy_(host)
    else:
        dist.all_reduce(t, group=group)
    return t


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous()
    if staged(x, group):
        host = x.cpu()
        out = torch.empty_like(host)
        dist.all_to_all_single(out, host, group=group)
        return out.to(x.device)
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, pending):
        ctx.group = group
        if pending is None:
            return _all_to_all(x, group)
        out, work = pending
        if work is not None:
            work.wait()
        return out

    @staticmethod
    def backward(ctx, dout):
        return _all_to_all(dout, ctx.group), None, None


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Exchange equal blocks of dim 0: block ``j`` of this rank goes to the
    group's rank ``j``, and block ``j`` of the result came from it."""
    return _AllToAll.apply(x, group, None)


class PendingAllToAll:
    """An exchange issued ahead of the compute it overlaps
    (``async_op=True`` under NCCL; a staged gloo exchange completes when
    it is issued).  :meth:`wait` returns the differentiable result."""

    def __init__(self, x: torch.Tensor, group):
        self.x, self.group = x.contiguous(), group
        if staged(self.x, group):
            self.out, self.work = _all_to_all(self.x, group), None
        else:
            self.out = torch.empty_like(self.x)
            self.work = dist.all_to_all_single(self.out, self.x, group=group,
                                               async_op=True)

    def wait(self) -> torch.Tensor:
        return _AllToAll.apply(self.x, self.group, (self.out, self.work))


class _PsumPartials(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, group):
        return all_reduce_(y.clone(), group)

    @staticmethod
    def backward(ctx, dy):
        return dy, None


def psum_partials(y: torch.Tensor, group) -> torch.Tensor:
    """Sum of the ranks' partial ``y`` over ``group``; identity backward."""
    return _PsumPartials.apply(y, group)


class _EnterReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dx):
        return all_reduce_(dx.clone(), ctx.group), None


def enter_replicated(x: torch.Tensor, group) -> torch.Tensor:
    """Identity; the backward sums the ranks' partial gradients."""
    return _EnterReplicated.apply(x, group)


class _Pmean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.n = dist.get_world_size(group)
        return all_reduce_(x.clone(), group) / ctx.n

    @staticmethod
    def backward(ctx, dx):
        return dx / ctx.n, None


def pmean(x: torch.Tensor, group) -> torch.Tensor:
    """Mean of ``x`` over ``group``; the backward scales by ``1/n``."""
    return _Pmean.apply(x, group)


def all_gather_cat(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Concatenate every rank's ``x`` along ``dim`` in group-rank order
    (no gradient)."""
    n = dist.get_world_size(group)
    src = x.detach().contiguous()
    if staged(src, group):
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim).to(x.device)
