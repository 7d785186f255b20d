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

:func:`trace_step` is the dry run's counterpart of the reference's
compiled memory and cost analysis (``repro/roofline.py:108-165``,
``repro/train/loop.py:169-192``): it runs a step, on fake tensors for the
dry run or on real ones, and follows the live bytes of every storage the
step allocates, from its allocation to its death (weak references), to
the reference's ``arg_bytes`` / ``out_bytes`` / ``temp_bytes`` /
``alias_bytes`` / ``peak_bytes``, beside the step's operations, bytes
accessed, kernel calls and collectives.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import time
import weakref

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


def _tensors(tree) -> list[torch.Tensor]:
    """The tensors of a tree of dicts, lists, tuples (named ones too) and
    dataclasses (``AdamWState``)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [t for f in dataclasses.fields(tree)
                for t in _tensors(getattr(tree, f.name))]
    return []


def empty_tree(tree, device):
    """``tree`` (dicts, lists, tuples, named tuples of tensors, e.g. on
    the meta device) with every tensor replaced by an empty one of its
    shape and dtype on ``device``; under ``FakeTensorMode``, fake ones."""
    if isinstance(tree, torch.Tensor):
        return torch.empty(tree.shape, dtype=tree.dtype, device=device)
    if isinstance(tree, dict):
        return {k: empty_tree(v, device) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(empty_tree(v, device) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(empty_tree(v, device) for v in tree)
    return tree


def _storages(tree) -> dict[int, int]:
    """``{storage key: nbytes}`` of the distinct storages in ``tree``."""
    out = {}
    for t in _tensors(tree):
        st = t.untyped_storage()
        out[st._cdata] = st.nbytes()
    return out


def _nbytes(x) -> int:
    """Bytes of the tensors in ``x`` (a tensor, or lists and tuples of
    them and of other values), each counted as a view: its elements."""
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(v) for v in x)
    return 0


class _LiveBytes(TorchDispatchMode):
    """Follows every storage an op allocates (not a view's, not an
    in-place update's, not one that existed before: ``known``) from its
    allocation to its death, sums each op's bytes accessed (its tensor
    inputs read and outputs written once; views move nothing) and counts
    its operations by ``torch.utils.flop_counter``'s formulas (aten's
    products and attention; ``FlopCounterMode``'s registry, read here so
    that a trace takes one mode, not two)."""

    def __init__(self, known):
        from torch.utils.flop_counter import flop_registry
        super().__init__()
        self.live = self.peak = 0
        self.bytes_accessed = 0
        self.flops = 0
        self.known = set(known)
        self._refs: dict[int, weakref.ref] = {}
        self._formulas = flop_registry
        self._ops: dict = {}      # op -> (moves nothing, in place, formula)

    def _died(self, key: int, nbytes: int, ref) -> None:
        if self._refs.get(key) is ref:
            del self._refs[key]
            self.live -= nbytes

    def _track(self, t) -> None:
        if isinstance(t, (list, tuple)):
            for v in t:
                self._track(v)
            return
        if not isinstance(t, torch.Tensor):
            return
        st = t.untyped_storage()
        key = st._cdata
        if key in self.known or key in self._refs:
            return
        nbytes = st.nbytes()
        self._refs[key] = weakref.ref(
            st, lambda ref, k=key, n=nbytes: self._died(k, n, ref))
        self.live += nbytes
        self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        op = self._ops.get(func)
        if op is None:
            # device queries and aliases move nothing; an update in place
            # allocates nothing
            op = self._ops[func] = (
                func.namespace == "prim" or func.is_view,
                func._schema.is_mutable,
                self._formulas.get(func._overloadpacket))
        still, in_place, formula = op
        if still:
            return out
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        self.bytes_accessed += (_nbytes(args) + _nbytes(tuple(kwargs.values()))
                                + _nbytes(out))
        if not in_place:
            self._track(out)
        return out


@dataclasses.dataclass
class StepTrace:
    """What :func:`trace_step` saw of one call.

    Memory, in the reference's terms (XLA's ``memory_analysis``):
    ``arg_bytes`` the distinct storages of the arguments, ``out_bytes``
    those of the outputs, ``alias_bytes`` the outputs' storages that are
    arguments' (the port's AdamW update writes the parameters and moments
    in place, so a training step returns its arguments: they alias, as
    the reference's donated buffers do), ``temp_bytes`` the most bytes
    the call's own allocations held at once, less its new outputs, and
    ``peak_bytes = arg + out + temp - alias`` (the arguments plus that
    most).  ``flops``: aten's products and attention by
    ``torch.utils.flop_counter``'s formulas plus the kernels' recorded
    operations; ``bytes_accessed``:
    each aten op's inputs and outputs once (no fusion assumed) plus the
    kernels' recorded bytes; ``kernels``: ``_lib.DryRecord.kernels``
    (fake CUDA tensors only); ``collectives``: the
    ``collectives.Recording``."""

    arg_bytes: int
    out_bytes: int
    temp_bytes: int
    alias_bytes: int
    peak_bytes: int
    flops: float
    bytes_accessed: float
    kernels: dict
    collectives: object
    seconds: float


def trace_step(fn, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` and return ``(output, StepTrace)``.
    On fake tensors (``torch._subclasses.FakeTensorMode``) nothing is
    allocated or computed and a kernel wrapper that a fake CUDA tensor
    reaches records its call (``kernels._lib.dry_run``) instead of
    launching; on real tensors the same accounting follows the real
    step.  The caller enters the fake mode."""
    from repro_torch.core.collectives import recording
    from repro_torch.kernels import _lib
    arg_st = _storages((args, kwargs))
    fake = any(_lib.is_fake(t) for t in _tensors((args, kwargs)))
    live = _LiveBytes(arg_st)
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        dry = stack.enter_context(_lib.dry_run()) if fake else None
        coll = stack.enter_context(recording())
        stack.enter_context(live)
        out = fn(*args, **kwargs)
    seconds = time.perf_counter() - t0
    gc.collect()
    out_st = _storages(out)
    new_out = sum(n for k, n in out_st.items() if k not in arg_st)
    alias = sum(n for k, n in out_st.items() if k in arg_st)
    arg = sum(arg_st.values())
    temp = live.peak - new_out
    kernels = dry.kernels if dry is not None else {}
    return out, StepTrace(
        arg_bytes=arg, out_bytes=sum(out_st.values()), temp_bytes=temp,
        alias_bytes=alias, peak_bytes=arg + sum(out_st.values()) + temp
        - alias,
        flops=float(live.flops) + sum(k["ops"] for k in kernels.values()),
        bytes_accessed=float(live.bytes_accessed)
        + sum(k["bytes"] for k in kernels.values()),
        kernels=kernels, collectives=coll, seconds=seconds)
