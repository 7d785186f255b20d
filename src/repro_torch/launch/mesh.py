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

:class:`Hardware` holds the per-device constants of the roofline cost
model (``roofline.py``), the counterpart of the reference's module
constants; :data:`H100_SXM` is the port's default and
:func:`axis_bandwidth` charges a mesh axis its tier's bandwidth.
"""

from __future__ import annotations

import itertools
import math
import os
from dataclasses import dataclass
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

    def coords(self, rank: int) -> dict[str, int]:
        """The coordinates of ``rank`` on every axis."""
        return dict(self._coords[rank])

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


@dataclass(frozen=True)
class Hardware:
    """Per-device constants of the roofline cost model (``roofline.py``),
    the counterpart of the reference's module constants
    (``repro/launch/mesh.py:32-37``).  ``gemm_tile`` is the width a
    grouped GEMM's minor dimension pads to: the cost model charges a
    sliver narrower than a tile at the tile's cost."""

    name: str
    peak_flops_bf16: float      # FLOP/s, dense bf16
    hbm_bw: float               # B/s
    hbm_bytes: int
    intra_node_bw: float        # B/s per device, per direction
    cross_node_bw: float        # B/s per device
    gemm_tile: int


#: The port's default: one H100 SXM5 80GB of a DGX H100.  From the
#: datasheets: 989e12 dense bf16 FLOP/s (NVIDIA H100 Tensor Core GPU
#: datasheet, SXM5, without sparsity); HBM3 at 3.35e12 B/s, 80 GB; NVLink 4
#: through NVSwitch at 900 GB/s per GPU, i.e. 450e9 B/s in each direction;
#: across nodes one 400 Gb/s ConnectX-7 NIC per GPU (DGX H100 user guide),
#: 50e9 B/s.  The tile is the N tile of the ``up``/``down`` grouped GEMMs
#: (``csrc/moe_wgmma.cuh``: 128).  NVLink and the NIC cannot be measured on
#: a machine with one card: ranks that share it read each other's memory on
#: the card (``core/collectives.py``), which none of these numbers
#: describes.
H100_SXM = Hardware(name="H100 SXM5 80GB", peak_flops_bf16=989e12,
                    hbm_bw=3.35e12, hbm_bytes=80 * 10 ** 9,
                    intra_node_bw=450e9, cross_node_bw=50e9, gemm_tile=128)


def axis_bandwidth(axis: str, hw: Hardware = H100_SXM) -> float:
    """Bytes/s the collective cost model charges for traffic over
    ``axis``: ``'node'`` and ``'pod'`` cross the network between hosts,
    every other axis stays inside the node (the reference's rule)."""
    return hw.cross_node_bw if axis in ("node", "pod") else hw.intra_node_bw


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
    collectives then read the tensors of ranks on the same card through
    CUDA IPC, and stage the others' through host memory, see
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
