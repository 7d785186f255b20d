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
"""

from __future__ import annotations

import json
import os
import re

import numpy as np
import torch

from repro_torch.train.optimizer import AdamWState


def _flatten(tree, prefix: str = "") -> dict:
    """Leaf path -> leaf, in the tree's order."""
    if isinstance(tree, AdamWState):
        return {"step": tree.step, **_flatten(tree.mu, "mu/"),
                **_flatten(tree.nu, "nu/")}
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
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


def _from_numpy(a: np.ndarray, template: torch.Tensor) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:
        a = a.view(np.uint16)            # ml_dtypes' bfloat16, read raw
    t = (torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
         if a.dtype == np.uint16 else torch.from_numpy(a))
    return t.to(device=template.device, dtype=template.dtype, copy=True)


def save_checkpoint(path: str, step: int, params, opt_state=None) -> None:
    """Write ``params`` (and ``opt_state``) under the directory ``path``."""
    os.makedirs(path, exist_ok=True)
    blobs = {"params": params}
    if opt_state is not None:
        blobs["opt"] = opt_state
    manifest = {"step": int(step), "files": []}
    for name, tree in blobs.items():
        fn = os.path.join(path, f"{name}.npz")
        np.savez(fn, **{k: _to_numpy(v) for k, v in _flatten(tree).items()})
        manifest["files"].append(f"{name}.npz")
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f)


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


def restore_checkpoint(path: str, params_template, opt_template=None):
    """Returns ``(step, params)`` or, with ``opt_template``, ``(step,
    params, opt_state)``; each leaf in its template leaf's dtype and on its
    device.  A checkpoint written by the reference is read as well (see
    the module's docstring)."""
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

    def restore_tree(name, template):
        with np.load(os.path.join(path, f"{name}.npz")) as data:
            leaves = {}
            for key, tmpl in _flatten(template).items():
                arr = leaf(data, key)
                if not isinstance(tmpl, torch.Tensor):     # AdamW's step
                    leaves[key] = int(arr)
                    continue
                if arr.shape != tuple(tmpl.shape):
                    raise ValueError(
                        f"checkpoint shape mismatch at {key}: "
                        f"{arr.shape} vs {tuple(tmpl.shape)}")
                leaves[key] = _from_numpy(arr, tmpl)
        return _unflatten(template, leaves)

    out = [manifest["step"], restore_tree("params", params_template)]
    if opt_template is not None:
        out.append(restore_tree("opt", opt_template))
    return tuple(out)
