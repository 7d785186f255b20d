"""Checkpoints of the port's parameter tree and AdamW state as ``.npz``
files, in the layout of ``repro/train/checkpointing.py``; the port also
restores the reference's own checkpoints.

A checkpoint is a directory holding ``manifest.json`` (``{"step",
"files"}``), ``params.npz`` and, when an optimizer state is saved,
``opt.npz``.  The port writes the keys of its own tree: the flattened
paths of its per-layer list (``layers/0/attn/wq``, ``embed``; ``step``,
``mu/3``, ``nu/3`` for an
:class:`~repro_torch.train.optimizer.AdamWState`, whose moments are a
list in the parameter tree's leaf order).  A bfloat16 leaf is
stored as its ``uint16`` bit pattern, the convention of
``repro_torch.interop`` (the port stores no other ``uint16`` leaf), and
comes back as bfloat16 before any cast.

What is exchanged with the reference: :func:`restore_checkpoint` reads a
checkpoint that the reference's ``save_checkpoint`` wrote, recognised by
its keys (``jax.tree_util.keystr`` paths such as
``['layers'][0]['attn']['wq']`` over the tree stacked by layer group,
``.step``, ``.mu[...]`` and ``.nu[...]`` for its ``AdamWState``).  Layer
``i`` of the port is group ``i // P``, block ``i % P`` of the pattern
(``P = cfg.pattern_period``), as ``interop.params_from_jax`` slices it;
the keys are parsed as strings, with no JAX.  A bfloat16 leaf that the
reference saved through ``ml_dtypes`` loads as two raw bytes and is read
as its bit pattern.  What is not: the reference cannot read the port's
files (its keys are the port's paths), and the port's saves keep its own
keys.

Restoring reads each leaf of a template tree by its path, checks its shape
(a mismatch raises ``ValueError`` naming the key) and returns new tensors
in the template leaf's dtype and on its device: float32 masters restored
into a serving template (``interop.init_params(cfg, ...)``, matrices in
``cfg.dtype``) come back cast to the serving layout.

Under a mesh (``mesh`` and the parameters' ``specs``, as a training step
places them: ``sharding.param_specs`` / ``opt_specs``) a checkpoint still
holds the whole trees, in the same files: saving sends every rank's block
of each leaf in turn to rank 0, which writes the whole leaf, then every
rank waits at a barrier; restoring keeps this rank's block of each leaf
(the templates are this rank's blocks), reading only that block's bytes
from the file where its arrays are stored uncompressed (the files
written here; ``np.savez``'s too).  Either side streams one leaf at a
time, so no process holds a whole tree in host memory.
"""

from __future__ import annotations

import json
import os
import re
import struct
import zipfile

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import sharding as SH
from repro_torch.core.collectives import gather_to_rank0
from repro_torch.train.optimizer import AdamWState


def _flatten(tree, prefix: str = "") -> dict:
    """Leaf path -> leaf, in the tree's order."""
    if isinstance(tree, AdamWState):
        return {"step": tree.step, **_flatten(tree.mu, "mu/"),
                **_flatten(tree.nu, "nu/")}
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:                         # a tensor, the step, or a spec tuple
        return {prefix.rstrip("/"): tree}
    out = {}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}{k}/"))
    return out


def _unflatten(template, leaves, prefix: str = ""):
    """``template``'s structure with each leaf taken from ``leaves`` by
    its path."""
    if isinstance(template, AdamWState):
        return AdamWState(step=leaves["step"],
                          mu=_unflatten(template.mu, leaves, "mu/"),
                          nu=_unflatten(template.nu, leaves, "nu/"))
    if isinstance(template, dict):
        return {k: _unflatten(v, leaves, f"{prefix}{k}/")
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten(v, leaves, f"{prefix}{i}/")
                              for i, v in enumerate(template))
    return leaves[prefix.rstrip("/")]


def _to_numpy(leaf) -> np.ndarray:
    if not isinstance(leaf, torch.Tensor):
        return np.asarray(leaf)
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _host_tensor(a: np.ndarray) -> torch.Tensor:
    """A CPU tensor over the array (bfloat16 for a uint16 bit pattern)."""
    a = np.ascontiguousarray(a)
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:
        a = a.view(np.uint16)            # ml_dtypes' bfloat16, read raw
    return (torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
            if a.dtype == np.uint16 else torch.from_numpy(a))


def _whole_on_rank0(t: torch.Tensor, mesh, spec):
    """The whole leaf on rank 0 (None elsewhere) from every rank's block
    under ``spec``: one gather of the blocks to rank 0
    (``collectives.gather_to_rank0``), which places each by its rank's
    coordinates (a block that several ranks hold is placed more than once,
    with the same bits)."""
    if not SH.split_axes(spec, mesh):
        return t
    parts = gather_to_rank0(t, mesh.group(mesh.axis_names))
    if parts is None:
        return None
    src = parts[0]
    shape = [n * (mesh.axis_size(ax) if ax else 1)
             for n, ax in zip(src.shape, spec)]
    whole = torch.empty(shape, dtype=src.dtype, device=src.device)
    for r, part in enumerate(parts):
        coords = mesh.coords(r)
        view = whole
        for dim, ax in enumerate(spec):
            if ax is None or mesh.axis_size(ax) == 1:
                continue
            idx = 0
            for a in (ax if isinstance(ax, tuple) else (ax,)):
                idx = idx * mesh.shape[a] + coords[a]
            n = src.shape[dim]
            view = view.narrow(dim, idx * n, n)
        view.copy_(part)
    return whole


def _stored_arrays(fn: str) -> dict:
    """Key -> a copy-on-write ``np.memmap`` of each array stored
    uncompressed in the ``.npz`` file ``fn``; {} when any member is
    compressed.  Reading a slice of it reads only those bytes, and nothing
    checks the whole member's CRC as ``np.load``'s zip reader does: on an
    H100 host a Mixtral-8x7B layer's experts (5.25 GiB, from the page
    cache) restored in 1.41 s whole and 2.17 s as a rank's block this
    way, 12.41 and 12.92 s through ``np.load``
    (``tools/ckpt_restore_ab.py``, PERF.md)."""
    out = {}
    with zipfile.ZipFile(fn) as zf, open(fn, "rb") as f:
        for info in zf.infolist():
            if info.compress_type != zipfile.ZIP_STORED:
                return {}
            f.seek(info.header_offset + 26)
            n_name, n_extra = struct.unpack("<HH", f.read(4))
            f.seek(info.header_offset + 30 + n_name + n_extra)
            version = np.lib.format.read_magic(f)
            shape, fortran, dtype = (
                np.lib.format.read_array_header_1_0(f) if version == (1, 0)
                else np.lib.format.read_array_header_2_0(f))
            if dtype.hasobject:
                return {}
            out[info.filename[:-len(".npy")]] = np.memmap(
                fn, dtype=dtype, mode="c", offset=f.tell(), shape=shape,
                order="F" if fortran else "C")
    return out


def _np_block(a: np.ndarray, spec, mesh, name: str) -> np.ndarray:
    """This rank's block of the whole array ``a`` under ``spec`` (a view:
    a memory-mapped array reads only the block's bytes)."""
    index = []
    for dim, ax in enumerate(spec):
        n = mesh.axis_size(ax) if ax is not None else 1
        if a.shape[dim] % n:
            raise ValueError(f"{name}: dim {dim} of {a.shape} does not "
                             f"divide over {ax}")
        size = a.shape[dim] // n
        i = mesh.flat_index(ax) if n > 1 else 0
        index.append(slice(i * size, (i + 1) * size))
    return a[tuple(index)]


def _write_npz(fn: str, items) -> None:
    """``np.savez``'s file from ``(key, array)`` pairs, written one array
    at a time."""
    with zipfile.ZipFile(fn, "w", zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, arr in items:
            with zf.open(f"{key}.npy", "w", force_zip64=True) as f:
                np.lib.format.write_array(f, np.asanyarray(arr),
                                          allow_pickle=False)


def save_checkpoint(path: str, step: int, params, opt_state=None, *,
                    mesh=None, specs=None) -> None:
    """Write ``params`` (and ``opt_state``) under the directory ``path``.
    Under a ``mesh`` they are this rank's blocks under ``specs`` (the
    parameters' spec tree); every rank must call, rank 0 writes the whole
    trees, and the call returns on every rank once they are written."""
    rank0 = mesh is None or mesh.rank == 0
    if rank0:
        os.makedirs(path, exist_ok=True)
    blobs = {"params": (params, specs)}
    if opt_state is not None:
        blobs["opt"] = (opt_state, SH.opt_specs(specs, params)
                        if specs is not None else None)
    manifest = {"step": int(step), "files": []}
    for name, (tree, tree_specs) in blobs.items():
        leaf_specs = (_flatten(tree_specs) if tree_specs is not None
                      else None)

        def items(tree=tree, leaf_specs=leaf_specs):
            for k, v in _flatten(tree).items():
                if leaf_specs is not None and isinstance(v, torch.Tensor):
                    v = _whole_on_rank0(v, mesh, leaf_specs[k])
                if rank0:
                    yield k, _to_numpy(v)

        if rank0:
            _write_npz(os.path.join(path, f"{name}.npz"), items())
        else:
            for _ in items():       # the gathers are collective
                pass
        manifest["files"].append(f"{name}.npz")
    if rank0:
        with open(os.path.join(path, "manifest.json"), "w") as f:
            json.dump(manifest, f)
    if mesh is not None:
        dist.barrier()


def _reference_key(path: str, period: int) -> tuple[str, int | None]:
    """The reference's ``keystr`` of a port parameter path, and the layer
    group to slice from its stacked leaf (None outside the layers)."""
    parts = path.split("/")
    if parts[0] != "layers":
        return "".join(f"['{p}']" for p in parts), None
    g, j = divmod(int(parts[1]), period)
    return f"['layers'][{j}]" + "".join(f"['{p}']" for p in parts[2:]), g


def _reference_period(path: str) -> int:
    """The block pattern's length in a reference checkpoint: the number of
    ``['layers'][j]`` entries of its parameter file (1 for a port file)."""
    with np.load(os.path.join(path, "params.npz")) as data:
        blocks = {int(m.group(1)) for k in data.files
                  if (m := re.match(r"\['layers'\]\[(\d+)\]", k))}
    return max(blocks) + 1 if blocks else 1


def restore_checkpoint(path: str, params_template, opt_template=None, *,
                       mesh=None, specs=None, device=None):
    """Returns ``(step, params)`` or, with ``opt_template``, ``(step,
    params, opt_state)``; each leaf in its template leaf's dtype and on its
    device.  A checkpoint written by the reference is read as well (see
    the module's docstring).  Under a ``mesh`` the templates are this
    rank's blocks under ``specs`` (the parameters' spec tree), and each
    leaf read whole is cut to this rank's block.  ``device`` puts every
    leaf there instead of on its template's (templates on the ``meta``
    device then hold no storage)."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    period = _reference_period(path)

    def leaf(data, key):
        """The template's leaf ``key`` (a port path) from ``data``, read
        from the reference's stacked leaf where the file is the
        reference's."""
        if key in data.files:
            return data[key]
        prefix = ""
        if key in ("step",) or key.startswith(("mu/", "nu/")):
            prefix, key = (".step", "") if key == "step" else (
                "." + key[:2], param_paths[int(key[3:])])
        ref_key, group = _reference_key(key, period) if key else ("", None)
        if prefix + ref_key not in data.files:
            raise KeyError(f"checkpoint {path} has neither {key!r} nor the "
                           f"reference's {prefix + ref_key!r}")
        arr = data[prefix + ref_key]
        return arr if group is None else arr[group]

    param_paths = list(_flatten(params_template))

    def restore_tree(name, template, tree_specs):
        leaf_specs = (_flatten(tree_specs) if tree_specs is not None
                      else None)
        fn = os.path.join(path, f"{name}.npz")
        stored = _stored_arrays(fn)
        with np.load(fn) as data:
            leaves = {}
            for key, tmpl in _flatten(template).items():
                arr = stored[key] if key in stored else leaf(data, key)
                if not isinstance(tmpl, torch.Tensor):     # AdamW's step
                    leaves[key] = int(arr)
                    continue
                if leaf_specs is not None:
                    arr = _np_block(arr, leaf_specs[key], mesh, key)
                t = _host_tensor(arr)
                if tuple(t.shape) != tuple(tmpl.shape):
                    raise ValueError(
                        f"checkpoint shape mismatch at {key}: "
                        f"{tuple(t.shape)} vs {tuple(tmpl.shape)}")
                leaves[key] = t.to(device=device or tmpl.device,
                                   dtype=tmpl.dtype, copy=True)
        return _unflatten(template, leaves)

    out = [manifest["step"],
           restore_tree("params", params_template, specs)]
    if opt_template is not None:
        out.append(restore_tree("opt", opt_template,
                                SH.opt_specs(specs, params_template)
                                if specs is not None else None))
    return tuple(out)
