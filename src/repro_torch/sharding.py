"""Sharding rules over a :class:`~repro_torch.launch.mesh.Mesh`, and the
placement of the parameter tree and the AdamW state by them.

The rules are the reference's (``repro/sharding.py``): each spec is a
tuple with one entry per dimension, ``None`` or the axis name (or tuple of
names) the dimension is split over, where the reference returns a JAX
``PartitionSpec`` of the same entries.  Every rule checks divisibility and
replicates a dimension that does not divide.  The port's parameter tree
keeps one dict per layer, so its layer leaves have no leading group
dimension and their specs none of the reference's ``None`` prefix.

:func:`param_specs` (FSDP x TP: dense in-projections ``('data',
'model')``, out-projections and ``embed`` ``('model', 'data')``, expert
leaves ``(expert axes, 'data', None)`` under expert parallelism and the
hidden dim on 'model' under ``tp``) and :func:`opt_specs` (the moments
mirror the parameters) are what a training step places its leaves by:
:func:`shard_params` keeps this rank's block of every leaf and
:func:`gather_params` is its inverse.  :func:`moe_specs` names only the
split the MoE body takes of the expert leaves (the reference's
``shard_map`` in_specs, ``models/moe_block.py:591-598``), every other leaf
whole: serving's layout, where the dense weights are replicated, and
:func:`local_params`.

:class:`FSDP` is what the training forward gathers by: each layer's
leaves are gathered whole just before the layer runs, inside its
checkpoint region, so the backward's recompute gathers them again instead
of keeping them (``core/collectives.gather_shard``).  The expert leaves
are gathered over 'data' only, in the model dtype (rounding is per
element, so this is the rounding of the whole leaf, at half the bytes);
their split over the expert axes is the MoE body's.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core.collectives import all_gather_cat, gather_shard

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
    """``fn(keys, leaf)`` over a tree of dicts and lists (a tuple is a
    leaf: a shape or a spec)."""
    if isinstance(tree, dict):
        return {k: _map_with_path(v, fn, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_with_path(v, fn, path + (str(i),))
                for i, v in enumerate(tree)]
    return fn(list(path), tree)


def _shape(leaf) -> tuple:
    return tuple(leaf) if isinstance(leaf, tuple) else tuple(leaf.shape)


def param_specs(params, mesh, *, fsdp: bool = True,
                moe_parallel: str = "auto"):
    """Spec tree congruent with ``params`` (tensors, or shape tuples as
    ``interop.param_shapes`` gives them).  ``fsdp=False`` drops the 'data'
    axis from every spec."""
    def spec(keys, leaf):
        axes = _leaf_spec(keys, _shape(leaf), mesh, moe_parallel)
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


def cache_specs(cfg, cache, mesh):
    """Specs of a decode cache (``transformer.init_cache``: one tuple a
    layer of ``(B, capacity or state...)`` leaves), by the reference's
    rule (``repro/sharding.py:127-158``) on its ``(groups, B, ...)``
    leaves without the group dimension: the batch over the data axes
    when it divides; the largest remaining dimension (the KV capacity or
    an SSM state dimension) over 'model', or, when the batch could not
    be split, over ``('data', 'model')`` for a long context (context
    parallelism), then 'model', then 'data'.  A 0-d leaf is replicated.
    ``cfg`` is unused, as in the reference."""
    dp = dp_axes(mesh)

    def spec(leaf):
        shape = _shape(leaf)
        if not shape:
            return ()
        axes = [None] * len(shape)
        b_ax = _fit(shape[0], mesh, dp) or _fit(shape[0], mesh, ("data",))
        axes[0] = b_ax
        if len(shape) >= 2:
            big = max(range(1, len(shape)), key=lambda i: shape[i])
            if b_ax is None:
                cand = (_fit(shape[big], mesh, ("data", "model"))
                        or _fit(shape[big], mesh, ("model",))
                        or _fit(shape[big], mesh, ("data",)))
            else:
                cand = _fit(shape[big], mesh, ("model",))
            axes[big] = cand
        return tuple(axes)

    return _map_cache(spec, cache)


def _map_cache(fn, *trees):
    """``fn(leaf, ...)`` over congruent cache trees (lists and tuples,
    named ones too, of tensors; the first tree's leaves are tensors)."""
    head = trees[0]
    if isinstance(head, torch.Tensor):
        return fn(*trees)
    parts = [_map_cache(fn, *leaves) for leaves in zip(*trees)]
    return type(head)(*parts) if hasattr(head, "_fields") \
        else type(head)(parts)


def shard_cache(cache, specs, mesh):
    """This rank's block of every leaf of a decode cache under
    :func:`cache_specs` (views; the dry run takes their shapes)."""
    return _map_cache(lambda t, s: _block(t, s, mesh, "cache"), cache,
                      specs)


def gather_cache(cache, specs, mesh):
    """One layer's cache blocks (:func:`shard_cache`) gathered whole but
    for the batch rows: each leaf over the axes its other dimensions are
    split over (no gradient).  How ``transformer.decode_step`` runs a
    layer over a cache split by :func:`cache_specs`."""
    def leaf(t, spec):
        for dim, ax in enumerate(spec):
            if dim and ax is not None and mesh.axis_size(ax) > 1:
                t = all_gather_cat(t, mesh.group(ax), dim)
        return t
    return _map_cache(leaf, cache, specs)


def keep_cache_block(block, whole, specs, mesh):
    """Write this rank's block of a layer's new ``whole`` cache (as
    :func:`gather_cache` gave it, then updated) into ``block`` in place;
    returns ``block``."""
    def leaf(b, w, spec):
        for dim, ax in enumerate(spec):
            if dim and ax is not None and mesh.axis_size(ax) > 1:
                size = w.shape[dim] // mesh.axis_size(ax)
                w = w.narrow(dim, mesh.flat_index(ax) * size, size)
        return b if w is b else b.copy_(w)
    return _map_cache(leaf, block, whole, specs)


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


def opt_specs(pspecs, params=None):
    """Specs of the port's AdamW state, as an ``AdamWState``: the step
    replicated, each moment its parameter's spec.  The moments are a list
    in the leaf order of the parameter tree they were made from: pass it
    as ``params`` (a tree's key order is its own, e.g. ``interop.
    params_from_jax``'s); without it, the order of ``pspecs``."""
    from repro_torch.train.optimizer import AdamWState
    leaves = spec_leaves(pspecs, params)
    return AdamWState(step=(), mu=list(leaves), nu=list(leaves))


def spec_leaves(specs, params=None) -> list[tuple]:
    """The spec of each leaf of ``params`` (default: of ``specs`` itself),
    in ``optimizer.tree_leaves`` order, looked up by the leaf's path."""
    out = []
    _map_with_path(specs if params is None else params,
                   lambda keys, _: out.append(_at(specs, keys)))
    return out


def split_axes(spec, mesh) -> tuple:
    """The mesh axes (of more than one rank) a leaf of ``spec`` is split
    over, in mesh order."""
    names = set()
    for ax in spec:
        if ax is not None:
            names.update(ax if isinstance(ax, tuple) else (ax,))
    return tuple(a for a in mesh.axis_names
                 if a in names and mesh.shape[a] > 1)


def _moe_split(keys: list[str], moe_parallel: str, mesh):
    """(dim, axes) along which the MoE body takes its slice of the leaf at
    ``keys``, or None for a leaf every rank holds whole."""
    if not _is_expert(keys):
        return None
    if moe_parallel in EP_MODES:
        return 0, expert_axes(mesh)
    if moe_parallel == "tp":
        return (2 if keys[-1] in _MOE_IN else 1), ("model",)
    return None


def _is_expert(keys: list[str]) -> bool:
    return (len(keys) >= 2 and keys[-2] == "moe"
            and keys[-1] in (_MOE_IN | _MOE_OUT))


def shard_axes(mesh, moe_parallel: str) -> tuple:
    """The axes the MoE body splits the expert leaves over for
    ``moe_parallel`` (``()`` when it splits none)."""
    split = _moe_split(["moe", "w1"], moe_parallel, mesh)
    return split[1] if split else ()


def moe_specs(params, mesh, moe_parallel: str):
    """Specs that split only the expert leaves, as the MoE body takes them
    under ``moe_parallel``; every other leaf whole."""
    def spec(keys, leaf):
        axes = [None] * len(_shape(leaf))
        split = _moe_split(keys, moe_parallel, mesh)
        if split is not None:
            dim, ax = split
            axes[dim] = ax if len(ax) > 1 else ax[0]
        return tuple(axes)
    return _map_with_path(params, spec)


def _block(t: torch.Tensor, spec, mesh, name: str) -> torch.Tensor:
    """This rank's block of the whole ``t`` under ``spec``."""
    for dim, ax in enumerate(spec):
        if ax is None or mesh.axis_size(ax) == 1:
            continue
        n = mesh.axis_size(ax)
        if t.shape[dim] % n:
            raise ValueError(f"{name}: dim {dim} of {tuple(t.shape)} does "
                             f"not divide over {ax}")
        size = t.shape[dim] // n
        t = t.narrow(dim, mesh.flat_index(ax) * size, size)
    return t


def shard_params(params, mesh, specs):
    """This rank's block of every leaf of ``params`` under ``specs``
    (contiguous copies, so an optimizer can update them in place; the
    tensor itself where its spec splits over no axis of more than one
    rank)."""
    def leaf(keys, t):
        spec = _at(specs, keys)
        if not split_axes(spec, mesh):
            return t
        return _block(t, spec, mesh, "/".join(keys)).detach().clone()
    return _map_with_path(params, leaf)


def gather_params(local, mesh, specs):
    """Inverse of :func:`shard_params`: every rank gets the whole tree (no
    gradient)."""
    def leaf(keys, t):
        for dim, ax in enumerate(_at(specs, keys)):
            if ax is not None and mesh.axis_size(ax) > 1:
                t = all_gather_cat(t, mesh.group(ax), dim)
        return t
    return _map_with_path(local, leaf)


def local_params(params, mesh, moe_parallel: str):
    """``params`` with the expert leaves sliced as the MoE body takes them
    under ``moe_parallel`` and every other leaf whole (serving's layout)."""
    return shard_params(params, mesh,
                        moe_specs(params, mesh, moe_parallel))


def relayout_moe(params, mesh, have: str, want: str):
    """``params`` laid out by :func:`local_params` for ``have``, with the
    expert leaves laid out for ``want`` instead: each MoE layer's gathered
    whole and sliced again, one layer at a time (every rank must call).
    The other leaves are the same tensors."""
    def layer(lp):
        if "moe" not in lp:
            return lp
        part = {"moe": lp["moe"]}
        whole = gather_params(part, mesh, moe_specs(part, mesh, have))
        return dict(lp, moe=local_params(whole, mesh, want)["moe"])
    return dict(params, layers=[layer(lp) for lp in params["layers"]])


def _at(tree, keys):
    for k in keys:
        tree = tree[int(k)] if isinstance(tree, list) else tree[k]
    return tree


@dataclass(frozen=True)
class FSDP:
    """How a training forward gathers its leaves: the mesh, the spec tree
    of the parameters, the axes the batch is split over (a gathered leaf's
    gradient is summed over those of its axes in the backward; over the
    others each rank keeps its slice) and the model dtype the expert
    leaves are gathered in."""

    mesh: object
    specs: dict
    batch_axes: tuple
    dtype: torch.dtype

    def gather(self, tree, specs, path=()):
        """``tree`` (leaves of this rank, ``specs`` congruent) with every
        leaf whole but the expert leaves' split over the expert axes."""
        def leaf(keys, t):
            spec = _at(specs, keys)
            expert = _is_expert(list(path) + keys)
            entries = tuple(
                (dim, self.mesh.group(ax), self.mesh.axis_size(ax),
                 self.mesh.flat_index(ax),
                 all(a in self.batch_axes
                     for a in (ax if isinstance(ax, tuple) else (ax,))))
                for dim, ax in enumerate(spec)
                if ax is not None and self.mesh.axis_size(ax) > 1
                and (not expert or ax == "data"))
            if not entries:
                return t
            return gather_shard(t, entries,
                                self.dtype if expert else t.dtype)
        return _map_with_path(tree, leaf)
