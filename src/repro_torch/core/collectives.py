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
  * :func:`pmean` — the mean over ranks; the backward scales by ``1/n``;
  * :func:`gather_shard` — a leaf's whole value from the ranks' blocks
    (FSDP); the backward sums the gradient over the axes the batch is
    split over and keeps this rank's block; under :func:`regather_saved`
    what autograd saves of the whole value is gathered again in the
    backward.

``torch.distributed.nn.functional.all_reduce`` is not used: its backward
sums the ``n`` identical cotangents of a replicated output, giving ``n``
times the gradient.

The transport follows the group's backend, ``dist.get_backend(group)``:
under NCCL the tensors stay on the card and the synchronous collectives
are ordered on the current stream.  Under gloo, CUDA tensors of at least
``IPC_MIN_BYTES`` of ranks that share one card (:func:`same_card`) are
read from each other's memory on the card through CUDA IPC: the ranks
exchange handles over gloo, each reads every rank's tensor in group-rank
order (so a sum is the same bits on every rank), and all wait until every
read is done before one of them may write its own again.  Otherwise a
CUDA tensor is copied to host memory, exchanged there by gloo and copied
back.

Over a :class:`ShapeGroup` (the groups of a ``launch.mesh.DryMesh``)
every function returns a tensor of its result's shape and moves nothing:
the dry run (``launch/dryrun.py``) traces a rank's step that way.

:func:`recording` counts the collectives called inside it, real or
shape-only, under the reference's kind names (``all-gather``,
``all-reduce``, ``reduce-scatter``, ``all-to-all``,
``collective-permute``; ``gather`` for :func:`gather_to_rank0`, which has
no counterpart there): each call's kind, its result's bytes (the
reference's convention, ``repro/roofline.py:49-54``) and the mesh axes of
its group.  The transport's own messages (handle exchanges, barriers) are
not counted.
"""

from __future__ import annotations

import contextlib
import socket
import weakref
from dataclasses import dataclass, field

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class ShapeGroup:
    """A group with no processes: the ``size`` ranks over mesh ``axes``
    of which this rank is number ``rank``."""

    axes: tuple
    size: int
    rank: int


def group_size(group) -> int:
    """The number of ranks of ``group`` (a process group or a
    :class:`ShapeGroup`)."""
    if isinstance(group, ShapeGroup):
        return group.size
    return dist.get_world_size(group)


def group_rank(group) -> int:
    """This rank's index in ``group``."""
    if isinstance(group, ShapeGroup):
        return group.rank
    return dist.get_rank(group)


#: the mesh axes of each process group a ``launch.mesh.Mesh`` made
_GROUP_AXES: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


def name_group(group, axes: tuple) -> None:
    """Remember that ``group`` spans mesh ``axes`` (for the record)."""
    _GROUP_AXES[group] = tuple(axes)


def group_axes(group) -> tuple:
    """The mesh axes ``group`` spans (``()`` for a group no mesh made)."""
    if isinstance(group, ShapeGroup):
        return group.axes
    return _GROUP_AXES.get(group, ())


@dataclass
class Recording:
    """The collectives called inside :func:`recording`: one ``(kind,
    result bytes, axes)`` a call, in call order."""

    calls: list = field(default_factory=list)

    def counts(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for kind, _, _ in self.calls:
            out[kind] = out.get(kind, 0) + 1
        return out

    def bytes_by_kind(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for kind, nbytes, _ in self.calls:
            out[kind] = out.get(kind, 0) + nbytes
        return out

    def bytes_by_axes(self) -> dict[str, int]:
        """Result bytes by the axes of the groups (``"data,model"``)."""
        out: dict[str, int] = {}
        for _, nbytes, axes in self.calls:
            key = ",".join(axes)
            out[key] = out.get(key, 0) + nbytes
        return out


_RECORDINGS: list[Recording] = []


@contextlib.contextmanager
def recording():
    """Count the collectives called inside (nested recordings each see
    every call)."""
    rec = Recording()
    _RECORDINGS.append(rec)
    try:
        yield rec
    finally:
        _RECORDINGS.remove(rec)


def _record(kind: str, nbytes: int, group) -> None:
    for rec in _RECORDINGS:
        rec.calls.append((kind, int(nbytes), group_axes(group)))


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def staged(t: torch.Tensor, group) -> bool:
    """True when ``t`` crosses ``group`` through host memory (a CUDA
    tensor over a gloo group)."""
    return (not isinstance(group, ShapeGroup) and t.is_cuda
            and dist.get_backend(group) == "gloo")


_SAME_CARD: dict = {}


def same_card(group, device: torch.device) -> bool:
    """True when every rank of the gloo ``group`` runs on ``device``'s card
    of this host.  Asked of the group once, collectively (every rank of it
    must call), and remembered.  False for a shape-only group."""
    if isinstance(group, ShapeGroup):
        return False
    key = (group, device.index)
    if key not in _SAME_CARD:
        mine = (socket.gethostname(),
                str(torch.cuda.get_device_properties(device).uuid))
        every = [None] * dist.get_world_size(group)
        dist.all_gather_object(every, mine, group=group)
        _SAME_CARD[key] = all(e == mine for e in every)
    return _SAME_CARD[key]


#: Below this size a CUDA tensor crosses a one-card gloo group through host
#: memory: the handle exchange and the barrier of the IPC path are three
#: gloo messages, which cost more than staging a small tensor (Mixtral-8x7B
#: served on two ranks of one H100 by ``chip_smoke.py`` phase 49: 41.8-51.6
#: tokens/s a rank with every tensor through IPC, 53.4-57.6 with every
#: tensor staged; PERF.md).
IPC_MIN_BYTES = 1 << 20


def _ipc(t: torch.Tensor, group) -> bool:
    """True when ``t`` crosses ``group`` through CUDA IPC: a CUDA tensor
    of at least ``IPC_MIN_BYTES`` over a gloo group whose ranks share its
    card."""
    return (staged(t, group) and t.numel() * t.element_size()
            >= IPC_MIN_BYTES and same_card(group, t.device))


def _peer_views(t: torch.Tensor, group) -> list[torch.Tensor]:
    """Every rank's ``t`` (the same shape on each) in group-rank order:
    this rank's own, the others' as views of their memory on the card.
    Call :func:`_reads_done` once the views have been read."""
    from torch.multiprocessing.reductions import reduce_tensor
    t = t.detach().contiguous()
    rebuild, args = reduce_tensor(t)
    every = [None] * dist.get_world_size(group)
    dist.all_gather_object(every, args, group=group)
    me = dist.get_rank(group)
    return [t if r == me else rebuild(*a) for r, a in enumerate(every)]


def _reads_done(group) -> None:
    """Wait until every rank of ``group`` has read the others' tensors:
    only then may a rank write its own again (or free it: blocks another
    process still maps wait in PyTorch's IPC limbo, collected here)."""
    torch.cuda.current_stream().synchronize()
    dist.barrier(group=group)
    torch.cuda.ipc_collect()


def transport(group, device: torch.device) -> str:
    """How tensors on ``device`` travel over ``group``, for run records
    (a collective call over ``group`` on the card)."""
    if isinstance(group, ShapeGroup):
        return "none (shape-only group)"
    backend = dist.get_backend(group)
    if device.type == "cuda" and backend == "gloo":
        if same_card(group, device):
            return ("gloo; CUDA IPC on one card from "
                    f"{IPC_MIN_BYTES >> 20} MiB, host memory below")
        return "gloo, staged through host memory"
    return backend


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """In-place sum over ``group`` (no gradient); returns ``t``."""
    _record("all-reduce", _nbytes(t), group)
    if isinstance(group, ShapeGroup):
        return t
    if _ipc(t, group):
        views = _peer_views(t, group)
        acc = views[0].clone()
        for v in views[1:]:
            acc += v
        del views
        _reads_done(group)
        t.copy_(acc)
    elif staged(t, group):
        host = t.cpu()
        dist.all_reduce(host, group=group)
        t.copy_(host)
    else:
        dist.all_reduce(t, group=group)
    return t


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous()
    _record("all-to-all", _nbytes(x), group)
    if isinstance(group, ShapeGroup):
        return torch.empty_like(x)
    if _ipc(x, group):
        me = dist.get_rank(group)
        views = _peer_views(x, group)
        n = len(views)
        out = torch.stack([v.reshape(n, -1)[me] for v in views])
        del views
        _reads_done(group)
        return out.view_as(x)
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
        if isinstance(group, ShapeGroup) or staged(self.x, group):
            self.out, self.work = _all_to_all(self.x, group), None
        else:
            _record("all-to-all", _nbytes(self.x), group)
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
        ctx.n = group_size(group)
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
    n = group_size(group)
    src = x.detach().contiguous()
    shape = list(src.shape)
    shape[dim] *= n
    _record("all-gather", _nbytes(src) * n, group)
    if isinstance(group, ShapeGroup):
        return src.new_empty(shape)
    if _ipc(src, group):
        views = _peer_views(src, group)
        out = torch.cat(views, dim=dim)
        del views
        _reads_done(group)
        return out
    if staged(src, group):
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim).to(x.device)


def _gather_whole(shard: torch.Tensor, entries, dtype) -> torch.Tensor:
    w = shard.detach().to(dtype)
    for dim, group, _, _, _ in entries:
        w = all_gather_cat(w, group, dim)
    return w


class _GatherShard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, shard, entries, dtype):
        ctx.entries, ctx.dtype = entries, shard.dtype
        return _gather_whole(shard, entries, dtype)

    @staticmethod
    def backward(ctx, g):
        g = g.to(dtype=ctx.dtype, copy=True)
        for dim, group, n, idx, reduce in reversed(ctx.entries):
            if reduce:
                g = all_reduce_(g.contiguous(), group)
            size = g.shape[dim] // n
            g = g.narrow(dim, idx * size, size)
        return g.contiguous(), None, None


def gather_shard(shard: torch.Tensor, entries, dtype) -> torch.Tensor:
    """The whole value of a leaf split over the ranks, cast to ``dtype``
    before it is gathered.  ``entries`` are ``(dim, group, n, index,
    reduce)`` per split dimension: the group of the axes the dimension is
    split over, their size and this rank's index over them, and whether
    the batch is split over them.  The backward casts the gradient back to
    the shard's dtype and, per dimension, sums it over the group where
    ``reduce`` (each rank holds the gradient of its own batch rows), then
    keeps this rank's slice; where not, every rank of the group holds the
    same gradient and keeps its slice.  Nothing but the entries is saved:
    the whole value lives as long as its consumers keep it, and under
    :func:`regather_saved` a consumer's backward gathers it again."""
    w = _GatherShard.apply(shard, entries, dtype)
    w._gathered_from = (shard, entries, dtype)
    return w


def _pack_gathered(t: torch.Tensor):
    base = t if t._base is None else t._base
    src = getattr(base, "_gathered_from", None)
    if src is None or t.dtype != base.dtype:
        return t
    return src, t.size(), t.stride(), t.storage_offset()


def _unpack_gathered(packed):
    if isinstance(packed, torch.Tensor):
        return packed
    src, size, stride, offset = packed
    return _gather_whole(*src).as_strided(size, stride, offset)


def regather_saved():
    """A context in which autograd saves a value :func:`gather_shard`
    returned (or a view of it) as its shard, and the backward gathers it
    again where it needs it, so no whole leaf is kept from the forward to
    the backward.  Non-reentrant checkpoint regions inside it save by
    their own rules (their recompute gathers again).  Every rank unpacks
    in the same order, as its graph is the same, so the gathers match."""
    return torch.autograd.graph.saved_tensors_hooks(_pack_gathered,
                                                    _unpack_gathered)


def gather_to_rank0(x: torch.Tensor, group) -> list[torch.Tensor] | None:
    """Every rank's ``x`` (the same shape on each), in group-rank order, on
    the group's rank 0 (on ``x``'s device); None on the others."""
    me = group_rank(group)
    src = x.detach().contiguous()
    n = group_size(group)
    _record("gather", _nbytes(src) * n, group)
    if isinstance(group, ShapeGroup):
        return [torch.empty_like(src) for _ in range(n)] if me == 0 else None
    if _ipc(src, group):
        views = _peer_views(src, group)
        out = [v.clone() for v in views] if me == 0 else None
        del views
        _reads_done(group)
        return out
    host = src.cpu()
    parts = [torch.empty_like(host) for _ in range(n)] if me == 0 else None
    dist.gather(host, parts, dst=dist.get_global_rank(group, 0), group=group)
    return None if parts is None else [p.to(x.device) for p in parts]
