"""Saved-residual accounting: the bytes a function's autograd graph holds
for its backward.

The PyTorch counterpart of ``repro/compat.py:saved_residuals`` and
``saved_residual_nbytes``, which list what JAX's autodiff saves.  Here a
dispatch mode notes every tensor storage that an op run by ``f``
allocates.  Once ``f`` has returned, with its outputs (and so its graph) still
alive, each noted storage that is still alive and is not an argument's or
an output's is held for the backward: tensors that autograd nodes and
custom Functions saved, and what checkpoint regions keep (their inputs
and the outputs a selective-checkpoint policy stores).  An outer
``saved_tensors_hooks`` alone would not see those: inside a non-reentrant
region the region's own hooks replace it.  Storages reached from the
arguments (the parameters, the batch) are excluded, as the reference
excludes residuals "from the argument".

A cache that ``f`` fills on its first call would count as held, so warm
such a function before measuring it.
"""

from __future__ import annotations

import gc

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves


class _StorageWatch(TorchDispatchMode):
    """Notes the storage of every tensor an op allocates (views and
    in-place updates allocate none)."""

    def __init__(self):
        super().__init__()
        self.seen: dict[int, tuple] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.is_view or func._schema.is_mutable:
            return out      # allocates nothing: an alias or an update
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                st = t.untyped_storage()
                old = self.seen.get(st._cdata)
                # a freed storage's address may be reused by a new one
                if old is None or old[0].expired():
                    self.seen[st._cdata] = (StorageWeakRef(st), st.nbytes(),
                                            tuple(t.shape), t.dtype,
                                            str(func))
        return out


def _storage_keys(tree) -> set[int]:
    return {t.untyped_storage()._cdata for t in tree_leaves(tree)
            if isinstance(t, torch.Tensor)}


def saved_residuals(f, *args, **kwargs) -> list[tuple]:
    """``(shape, dtype, nbytes, op)`` of every storage that ``f(*args,
    **kwargs)`` allocated and its graph still holds once it returns
    (``shape`` and ``dtype`` of the first tensor seen on the storage,
    ``op`` the operator that made it), arguments and outputs excluded."""
    exclude = _storage_keys((args, kwargs))
    watch = _StorageWatch()
    with watch:
        out = f(*args, **kwargs)
    gc.collect()
    exclude |= _storage_keys(out)
    held = [(shape, dtype, nbytes, op)
            for key, (ref, nbytes, shape, dtype, op) in watch.seen.items()
            if key not in exclude and not ref.expired() and nbytes]
    del out
    return held


def saved_residual_nbytes(f, *args, **kwargs) -> int:
    """Total bytes of the activation residuals ``f``'s graph holds for its
    backward, arguments (the parameters) excluded."""
    return sum(nbytes for _, _, nbytes, _ in
               saved_residuals(f, *args, **kwargs))
