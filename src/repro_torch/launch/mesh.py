"""Device meshes over ``torch.distributed``.

The reference lays its devices out as a JAX mesh with named axes
(``repro/launch/mesh.py``) and lets ``shard_map`` run one program per
device.  The port runs one process per rank; a :class:`Mesh` names the
axes of the process group's ranks, maps each rank to its coordinates in
row-major order (the last axis varies fastest, as ``jax.make_mesh`` lays
out its devices), and holds one process group for every subset of axes:
the ranks that share this rank's coordinates on all the other axes.

Every rank creates every group, in the same order, because
``dist.new_group`` is a collective call over the whole world.

:func:`init_distributed` starts the process group from torchrun's
variables (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``): NCCL with
``cuda:LOCAL_RANK`` on the card, one card per rank, and gloo on the CPU.
Ranks that share a card over gloo are a setup the caller asks for by
name (``backend="gloo"``), never one inferred from the card count.  A
world of one rank is allowed and needs no rendezvous address.
"""

from __future__ import annotations

import itertools
import math
import os
from datetime import timedelta

import torch
import torch.distributed as dist

from repro_torch.core.device import resolve_device


class Mesh:
    """Named axes over the ranks of the default process group.

    ``shape`` maps each axis name to its size, in axis order (like the
    reference's ``mesh.shape``); their product must be the world size."""

    def __init__(self, sizes, names):
        if not dist.is_initialized():
            raise RuntimeError("Mesh needs a process group: call "
                               "launch.mesh.init_distributed first")
        sizes, names = tuple(int(s) for s in sizes), tuple(names)
        if len(sizes) != len(names) or len(set(names)) != len(names):
            raise ValueError(f"mesh axes {names} do not match sizes {sizes}")
        world = dist.get_world_size()
        if math.prod(sizes) != world:
            raise ValueError(f"mesh {dict(zip(names, sizes))} has "
                             f"{math.prod(sizes)} ranks; the world has "
                             f"{world}")
        self.axis_names = names
        self.shape = dict(zip(names, sizes))
        self.rank = dist.get_rank()
        self._coords = [self._unravel(r) for r in range(world)]
        self._groups: dict[tuple, dist.ProcessGroup] = {}
        for n_axes in range(1, len(names) + 1):
            for axes in itertools.combinations(names, n_axes):
                for ranks in self._slices(axes):
                    group = dist.new_group(ranks)
                    if self.rank in ranks:
                        self._groups[axes] = group

    def _unravel(self, rank: int) -> dict[str, int]:
        coords = {}
        for name in reversed(self.axis_names):
            rank, coords[name] = divmod(rank, self.shape[name])
        return coords

    def _slices(self, axes: tuple) -> list[list[int]]:
        """The rank lists that vary over ``axes`` only, in order of their
        first rank."""
        others = [a for a in self.axis_names if a not in axes]
        slices: dict[tuple, list[int]] = {}
        for r, c in enumerate(self._coords):
            slices.setdefault(tuple(c[a] for a in others), []).append(r)
        return list(slices.values())

    def _axes(self, axes) -> tuple:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        unknown = set(axes) - set(self.axis_names)
        if unknown or not axes:
            raise ValueError(f"axes {axes} are not a subset of the mesh "
                             f"axes {self.axis_names}")
        return tuple(a for a in self.axis_names if a in axes)

    def axis_index(self, name: str) -> int:
        """This rank's coordinate on axis ``name``."""
        return self._coords[self.rank][self._axes(name)[0]]

    def axis_size(self, axes) -> int:
        """Product of the sizes of ``axes`` (a name or a tuple of names)."""
        return math.prod(self.shape[a] for a in self._axes(axes))

    def flat_index(self, axes) -> int:
        """This rank's row-major index over ``axes`` (e.g. ``node *
        n_model + model`` over ``("node", "model")``)."""
        idx = 0
        for a in self._axes(axes):
            idx = idx * self.shape[a] + self.axis_index(a)
        return idx

    def group(self, axes) -> dist.ProcessGroup:
        """The process group of the ranks that share this rank's
        coordinates on every axis outside ``axes``; its ranks are in
        row-major order over ``axes``."""
        return self._groups[self._axes(axes)]


def make_debug_mesh(data: int = 1, model: int = 1) -> Mesh:
    """A ``('data', 'model')`` mesh over the world's ranks."""
    return Mesh((data, model), ("data", "model"))


def make_node_mesh(data: int = 1, node: int = 1, model: int = 1) -> Mesh:
    """A mesh with a factored expert axis, ``('data', 'node', 'model')``.

    'node' is the slow tier between hosts, 'model' the fast one inside a
    host: the expert-parallel modes shard experts over ``node x model``,
    and ``moe_parallel='ep_a2a_hier'`` runs its first hop over 'model' and
    its one cross-node hop over 'node'."""
    return Mesh((data, node, model), ("data", "node", "model"))


def init_distributed(device=None, *, backend: str | None = None,
                     init_method: str | None = None,
                     timeout: timedelta | None = None) -> torch.device:
    """Start the default process group (once) and return this rank's
    device.

    ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK`` / ``LOCAL_WORLD_SIZE`` are
    read as torchrun sets them (a lone process is rank 0 of 1).  On the
    card (the default device) the backend is NCCL on ``cuda:LOCAL_RANK``,
    and a host with fewer cards than ranks raises.  ``backend="gloo"`` on
    the card lets ranks share cards (``cuda:LOCAL_RANK % cards``; the
    collectives then stage through host memory, see
    ``core/collectives.py``).  On the CPU the backend is gloo.
    ``init_method`` defaults to torchrun's ``env://``; a world of one rank
    without ``MASTER_ADDR`` uses an in-process store.  ``timeout`` bounds
    every collective's wait (PyTorch's default when None)."""
    rank = int(os.environ.get("RANK", 0))
    world = int(os.environ.get("WORLD_SIZE", 1))
    local = int(os.environ.get("LOCAL_RANK", rank))
    dev = resolve_device(device)
    if backend not in (None, "nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: 'nccl' or 'gloo'")
    if dev.type == "cuda":
        n_cards = torch.cuda.device_count()
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        backend = backend or "nccl"
        if backend == "nccl" and local_world > n_cards:
            raise RuntimeError(
                f"{local_world} ranks on this host but {n_cards} visible "
                "cards: NCCL needs a card per rank (check "
                "CUDA_VISIBLE_DEVICES and --nproc-per-node), or pass "
                "backend='gloo' to share cards through host memory")
        dev = torch.device("cuda", local % n_cards)
        torch.cuda.set_device(dev)
    elif backend == "nccl":
        raise ValueError("backend 'nccl' needs the card; the CPU runs gloo")
    else:
        backend = "gloo"
    if dist.is_initialized():
        return dev
    if init_method is None and world == 1 and "MASTER_ADDR" not in os.environ:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, timeout=timeout)
    else:
        dist.init_process_group(backend, init_method=init_method or "env://",
                                rank=rank, world_size=world, timeout=timeout)
    return dev
