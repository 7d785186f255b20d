"""Sharding rules over a :class:`~repro_torch.launch.mesh.Mesh`, and the
slicing of the parameter tree that the distributed MoE path runs on.

The rules are the reference's (``repro/sharding.py``): each spec is a
tuple with one entry per dimension, ``None`` or the axis name (or tuple of
names) the dimension is split over, where the reference returns a JAX
``PartitionSpec`` of the same entries.  Every rule checks divisibility and
replicates a dimension that does not divide.  The port's parameter tree
keeps one dict per layer, so its layer leaves have no leading group
dimension and their specs none of the reference's ``None`` prefix.

What the port applies in this slice is :func:`local_params`: the slicing
the reference's MoE ``shard_map`` does on entry
(``models/moe_block.py:591-598``).  Under ``ep``, ``ep_a2a`` and
``ep_a2a_hier`` the expert dimension of ``w1``/``w2``/``w3`` is split over
the expert axes (``('node', 'model')`` node-major on a node mesh, else
``'model'``); under ``tp`` the hidden dimension is split over ``'model'``.
Every other leaf stays whole on every rank: FSDP over ``'data'`` and
tensor parallelism of the dense leaves (what :func:`param_specs` also
names) change memory, not numbers, and are not ported yet (ROADMAP).
:func:`gather_params` is the inverse of :func:`local_params`.
"""

from __future__ import annotations

from repro_torch.core.collectives import all_gather_cat

# names of leaves that project back down to d_model (row-parallel / "out")
_OUT_PROJ = {"wo", "w3", "w_down", "w_out"}
# MoE expert tensors (leading expert dim)
_MOE_IN = {"w1", "w2"}          # (E, d, h)
_MOE_OUT = {"w3"}               # (E, h, d)
EP_MODES = ("ep", "ep_a2a", "ep_a2a_hier")


def _fit(dim: int, mesh, axis):
    """``axis`` if ``dim`` divides evenly over it (and it spans more than
    one rank), else None."""
    if axis is None:
        return None
    sizes = 1
    for a in (axis if isinstance(axis, tuple) else (axis,)):
        if a not in mesh.axis_names:
            return None
        sizes *= mesh.shape[a]
    return axis if sizes > 1 and dim % sizes == 0 else None


def dp_axes(mesh) -> tuple:
    """The data-parallel axes of ``mesh`` (``pod`` and ``data``)."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def expert_axes(mesh) -> tuple:
    """The axes the expert dimension is split over under expert
    parallelism: ``('node', 'model')`` on a node mesh, else
    ``('model',)``."""
    return ("node", "model") if "node" in mesh.axis_names else ("model",)


def _leaf_spec(path_keys: list[str], shape: tuple, mesh,
               moe_parallel: str = "auto") -> tuple:
    name = path_keys[-1]
    dims = tuple(shape)

    def two_d(in_dim, out_dim, in_ax, out_ax):
        return (_fit(in_dim, mesh, in_ax), _fit(out_dim, mesh, out_ax))

    if len(dims) == 3 and name in (_MOE_IN | _MOE_OUT):
        # Expert-parallel when the expert count divides the expert axes
        # (or a forced ep* mode), else tensor-parallel on the expert hidden
        # dim; a node mesh factors the expert dim node-major.
        ep_ax = ("node", "model") if "node" in mesh.axis_names else "model"
        ep = _fit(dims[0], mesh, ep_ax) if moe_parallel == "auto" \
            else (moe_parallel in EP_MODES)
        if ep:
            return (ep_ax, _fit(dims[1], mesh, "data"), None)
        if name in _MOE_IN:                          # (E, d, h)
            return (None, _fit(dims[1], mesh, "data"),
                    _fit(dims[2], mesh, "model"))
        return (None, _fit(dims[1], mesh, "model"),  # (E, h, d)
                _fit(dims[2], mesh, "data"))
    if len(dims) == 2:
        if name == "embed":                          # (V, d)
            return two_d(dims[0], dims[1], "model", "data")
        if name in _OUT_PROJ:                        # (f, d)
            return two_d(dims[0], dims[1], "model", "data")
        return two_d(dims[0], dims[1], "data", "model")  # (d, f) in-proj
    return (None,) * len(dims)


def _map_with_path(tree, fn, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(v, fn, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_with_path(v, fn, path + (str(i),))
                for i, v in enumerate(tree)]
    return fn(list(path), tree)


def param_specs(params, mesh, *, fsdp: bool = True,
                moe_parallel: str = "auto"):
    """Spec tree congruent with ``params`` (tensors, or anything with a
    ``shape``).  ``fsdp=False`` drops the 'data' axis from every spec."""
    def spec(keys, leaf):
        axes = _leaf_spec(keys, tuple(leaf.shape), mesh, moe_parallel)
        if not fsdp:
            axes = tuple(None if ax == "data" or
                         (isinstance(ax, tuple) and "data" in ax) else ax
                         for ax in axes)
        return axes
    return _map_with_path(params, spec)


def batch_axes(mesh, batch_size: int) -> tuple:
    """The axes a batch of ``batch_size`` rows is split over: the data
    axes when the batch divides over them, else ``()`` (replicated)."""
    ax = _fit(batch_size, mesh, dp_axes(mesh)) or _fit(batch_size, mesh,
                                                        ("data",))
    return tuple(ax) if ax else ()


def batch_specs(batch_shapes: dict, mesh) -> dict:
    """Batch leaves split over the data axes when the batch divides (a
    single axis by its name, as ``PartitionSpec`` normalises it)."""
    out = {}
    for k, v in batch_shapes.items():
        axes = batch_axes(mesh, v.shape[0])
        bax = (axes[0] if len(axes) == 1 else axes) or None
        out[k] = (bax,) + (None,) * (len(v.shape) - 1)
    return out


def local_batch(batch: dict, specs: dict, mesh) -> dict:
    """This rank's rows of each batch leaf under ``specs``."""
    out = {}
    for k, v in batch.items():
        ax = specs[k][0]
        if ax is None:
            out[k] = v
            continue
        n = mesh.axis_size(ax)
        rows = v.shape[0] // n
        i = mesh.flat_index(ax)
        out[k] = v[i * rows:(i + 1) * rows]
    return out


def _moe_split(keys: list[str], moe_parallel: str, mesh):
    """(dim, axes) along which the MoE body takes its slice of the leaf at
    ``keys``, or None for a leaf every rank holds whole."""
    name = keys[-1]
    if len(keys) < 2 or keys[-2] != "moe" or name not in (_MOE_IN
                                                          | _MOE_OUT):
        return None
    if moe_parallel in EP_MODES:
        return 0, expert_axes(mesh)
    if moe_parallel == "tp":
        return (2 if name in _MOE_IN else 1), ("model",)
    return None


def shard_axes(mesh, moe_parallel: str) -> tuple:
    """The axes :func:`local_params` splits the expert leaves over for
    ``moe_parallel`` (``()`` when it splits none)."""
    split = _moe_split(["moe", "w1"], moe_parallel, mesh)
    return split[1] if split else ()


def sharded_leaves(params, mesh, moe_parallel: str) -> list[bool]:
    """For each leaf of ``params`` (in ``tree_leaves`` order), whether
    :func:`local_params` splits it."""
    flags = []
    _map_with_path(params, lambda keys, _: flags.append(
        _moe_split(keys, moe_parallel, mesh) is not None))
    return flags


def local_params(params, mesh, moe_parallel: str):
    """This rank's parameter tree for the MoE ``moe_parallel`` mode: the
    expert leaves sliced as the reference's ``shard_map`` in_specs slice
    them (contiguous copies, so they are leaves an optimizer can update in
    place; the tensor itself where the axes span one rank); every other
    leaf is ``params``' own tensor."""
    def leaf(keys, t):
        split = _moe_split(keys, moe_parallel, mesh)
        if split is None:
            return t
        dim, axes = split
        n = mesh.axis_size(axes)
        if t.shape[dim] % n:
            raise ValueError(f"{'/'.join(keys)}: dim {dim} of "
                             f"{tuple(t.shape)} does not divide over {axes}")
        if n == 1:
            return t
        size = t.shape[dim] // n
        return t.narrow(dim, mesh.flat_index(axes) * size,
                        size).detach().clone()
    return _map_with_path(params, leaf)


def gather_params(local, mesh, moe_parallel: str):
    """Inverse of :func:`local_params`: every rank gets the whole tree (no
    gradient)."""
    def leaf(keys, t):
        split = _moe_split(keys, moe_parallel, mesh)
        if split is None:
            return t
        dim, axes = split
        return all_gather_cat(t, mesh.group(axes), dim)
    return _map_with_path(local, leaf)
