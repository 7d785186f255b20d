"""Pluggable grouped-GEMM (gmm) backend registry.

Mirrors ``repro/core/gmm_backend.py``.  Every grouped GEMM of the expert
layer goes through two primitives:

  * ``gmm(lhs, rhs, group_sizes)`` — (S, d) @ (E, d, h) -> (S, h), rows of
    ``lhs`` grouped by expert (``group_sizes`` sums to <= S; trailing rows
    belong to no group and give zeros);
  * ``gmm_dw(lhs, dout, group_sizes)`` — (S, d), (S, h) -> (E, d, h), the
    per-group weight gradient.

Both accumulate in float32 and return ``lhs.dtype``.  The backends, under
the reference's names so that configs carry across unchanged:

  * ``ragged`` — ``torch._grouped_mm``, PyTorch's grouped GEMM, as the
    reference's ``ragged`` is ``jax.lax.ragged_dot[_general]`` (an XLA op,
    not a Pallas kernel); the trailing rows it leaves unwritten are zeroed
    here.  What it refuses (strides that are not a multiple of 16 bytes,
    mixed or unsupported dtypes) raises, naming the explicit backends;
  * ``segment`` — plain PyTorch, one float32 product per group; the
    oracle the other backends are held to (never picked by auto while
    ``ragged`` is available);
  * ``pallas`` — the port's hand-written kernels: gather-GMM over identity
    rows and the grouped weight gradient, each an autograd Function whose
    backward is built from the other;
  * ``pallas_fused`` — ``pallas`` plus the ``fused_moe`` capability flag:
    ``moe_ffn_blaze`` then runs whole SwiGLU layers through the fused
    forward and backward kernels (``kernels/fused_moe.py``).

Selection precedence (:func:`resolve`): call-site argument > the active
:func:`use_backend` scope > a config field > ``REPRO_GMM_BACKEND`` > auto
(the first available of ``ragged``, ``segment``).  ``pallas`` and
``pallas_fused`` are never auto-selected, as in the reference.  Long-lived
objects (the train step, the serving engine) resolve once and hold the
:class:`ResolvedBackend`.
"""

from __future__ import annotations

import contextlib
import os
from contextvars import ContextVar
from dataclasses import dataclass

import torch

from repro_torch.kernels._lib import is_fake
from repro_torch.kernels.gather_gmm import gather_gmm as _gather_gmm
from repro_torch.kernels.gmm_dw import gmm_dw as _gmm_dw_kernel

ENV_VAR = "REPRO_GMM_BACKEND"

_AUTO_PRIORITY = ("ragged", "segment")

_ACTIVE: ContextVar[str | None] = ContextVar("repro_torch_gmm_backend",
                                             default=None)


def _offsets_of(group_sizes: torch.Tensor) -> torch.Tensor:
    """(E,) group sizes -> (E+1,) int32 exclusive prefix sums."""
    gs = group_sizes.to(torch.int32)
    return torch.cat([gs.new_zeros(1), torch.cumsum(gs, 0, dtype=torch.int32)])


def _groups(group_sizes: torch.Tensor, S: int):
    off = [0] + torch.cumsum(group_sizes.long(), 0).tolist()
    for e in range(len(off) - 1):
        lo, hi = min(off[e], S), min(off[e + 1], S)
        if hi > lo:
            yield e, lo, hi


def _grouped_mm(a, b, offs):
    """``torch._grouped_mm`` with its refusals (mixed dtypes, strides that
    are not a multiple of 16 bytes) re-raised to name the backends that
    take every case."""
    try:
        return torch._grouped_mm(a, b, offs=offs)
    except RuntimeError as exc:
        raise RuntimeError(
            f"gmm backend 'ragged' (torch._grouped_mm) refuses {a.dtype} "
            f"{tuple(a.shape)} x {tuple(b.shape)} on {a.device}: {exc}; use "
            f"backend 'segment', 'pallas' or 'pallas_fused'") from exc


def _ends_of(group_sizes: torch.Tensor) -> torch.Tensor:
    """(E,) group sizes -> (E,) int32 inclusive prefix sums (the group
    ends that ``torch._grouped_mm`` takes as ``offs``)."""
    return torch.cumsum(group_sizes.to(torch.int32), 0, dtype=torch.int32)


def _ragged_gmm(lhs, rhs, ends):
    out = _grouped_mm(lhs, rhs, ends)
    # rows at and past the group total are left unwritten: zero them
    # without reading the total back to the host
    dead = torch.arange(lhs.shape[0], device=lhs.device) >= ends[-1]
    return out.masked_fill_(dead[:, None], 0)


def _ragged_dw(lhs, dout, ends):
    # the 2-D x 2-D form contracts each group's rows: (d, S) x (S, h) ->
    # (E, d, h), rows past the total in no group
    return _grouped_mm(lhs.t(), dout, ends)


class _RaggedGmm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, lhs, rhs, ends):
        ctx.save_for_backward(lhs, rhs, ends)
        return _ragged_gmm(lhs, rhs, ends)

    @staticmethod
    def backward(ctx, dout):
        lhs, rhs, ends = ctx.saved_tensors
        dout = dout.to(lhs.dtype).contiguous()
        dlhs = _ragged_gmm(dout, rhs.transpose(1, 2), ends)
        return dlhs, _ragged_dw(lhs, dout, ends).to(rhs.dtype), None


class _RaggedDw(torch.autograd.Function):
    @staticmethod
    def forward(ctx, lhs, dout, ends):
        ctx.save_for_backward(lhs, dout, ends)
        return _ragged_dw(lhs, dout, ends)

    @staticmethod
    def backward(ctx, ddw):
        lhs, dout, ends = ctx.saved_tensors
        ddw = ddw.to(lhs.dtype).contiguous()
        dlhs = _ragged_gmm(dout, ddw.transpose(1, 2), ends)
        ddout = _ragged_gmm(lhs, ddw, ends)
        return dlhs, ddout.to(dout.dtype), None


class RaggedBackend:
    """The reference's ``jax.lax.ragged_dot[_general]`` backend on
    ``torch._grouped_mm`` (float32 accumulation, output in ``lhs.dtype``),
    differentiable through an autograd Function built as ``pallas``'s."""

    name = "ragged"

    @staticmethod
    def available() -> bool:
        return hasattr(torch, "_grouped_mm")

    @staticmethod
    def gmm(lhs, rhs, group_sizes):
        return _RaggedGmm.apply(lhs.contiguous(), rhs, _ends_of(group_sizes))

    @staticmethod
    def gmm_dw(lhs, dout, group_sizes):
        return _RaggedDw.apply(lhs.contiguous(), dout.contiguous(),
                               _ends_of(group_sizes))


class SegmentBackend:
    """Plain PyTorch grouped GEMM: one float32 product per group's rows.
    Exact, so it doubles as the oracle of the parity tests.

    A fake tensor (``FakeTensorMode``) has no group sizes to read, so on
    fake tensors one product over every row stands for the groups'
    products: the output's shape and dtype and the inputs autograd keeps
    are theirs, for the bytes a trace of the call counts."""

    name = "segment"

    @staticmethod
    def available() -> bool:
        return True

    @staticmethod
    def gmm(lhs, rhs, group_sizes):
        S = lhs.shape[0]
        if is_fake(lhs):
            return (lhs.float() @ rhs[0].float()).to(lhs.dtype)
        out = lhs.new_zeros(S, rhs.shape[2], dtype=torch.float32)
        for e, lo, hi in _groups(group_sizes, S):
            out[lo:hi] = lhs[lo:hi].float() @ rhs[e].float()
        return out.to(lhs.dtype)

    @staticmethod
    def gmm_dw(lhs, dout, group_sizes):
        E = group_sizes.shape[0]
        if is_fake(lhs):
            dw = lhs.float().T @ dout.float()
            return dw.expand(E, *dw.shape).contiguous().to(lhs.dtype)
        out = lhs.new_zeros(E, lhs.shape[1], dout.shape[1],
                            dtype=torch.float32)
        for e, lo, hi in _groups(group_sizes, lhs.shape[0]):
            out[e] = lhs[lo:hi].float().T @ dout[lo:hi].float()
        return out.to(lhs.dtype)


# The kernels are wrapped in autograd Functions built from each other (the
# grouped GEMM is linear: d_lhs flows through the transposed weights, read
# in place by gather-GMM's ``trans_w``; d_rhs is the grouped weight
# gradient), so every backend is differentiable by plain autograd.


class _PallasGmm(torch.autograd.Function):
    """lhs @ rhs[e] per group; with ``trans`` the weight is stored
    (E, h, d) and used as its transpose."""

    @staticmethod
    def forward(ctx, lhs, w, off, trans):
        ctx.save_for_backward(lhs, w, off)
        ctx.trans = trans
        return _gather_gmm(lhs, None, off, w, epilogue=False, trans_w=trans)

    @staticmethod
    def backward(ctx, dout):
        lhs, w, off = ctx.saved_tensors
        dout = dout.to(lhs.dtype).contiguous()
        dlhs = _gather_gmm(dout, None, off, w, epilogue=False,
                           trans_w=not ctx.trans)
        dw = (_gmm_dw_kernel(dout, lhs, off) if ctx.trans
              else _gmm_dw_kernel(lhs, dout, off))
        return dlhs, dw.to(w.dtype), None, None


class _PallasDw(torch.autograd.Function):
    @staticmethod
    def forward(ctx, lhs, dout, off):
        ctx.save_for_backward(lhs, dout, off)
        return _gmm_dw_kernel(lhs, dout, off)

    @staticmethod
    def backward(ctx, ddw):
        lhs, dout, off = ctx.saved_tensors
        ddw = ddw.to(lhs.dtype).contiguous()
        dlhs = _gather_gmm(dout, None, off, ddw, epilogue=False,
                           trans_w=True)
        ddout = _gather_gmm(lhs, None, off, ddw, epilogue=False)
        return dlhs, ddout.to(dout.dtype), None


class PallasBackend:
    """The port's gather-GMM (identity rows) and grouped weight-gradient
    kernels; CPU tensors take their plain versions."""

    name = "pallas"

    @staticmethod
    def available() -> bool:
        return True

    @staticmethod
    def gmm(lhs, rhs, group_sizes):
        # A transposed view (the backward's w.transpose(1, 2)) is read in
        # place by gather-GMM's trans_w, never copied.
        trans = not rhs.is_contiguous() and rhs.transpose(1, 2).is_contiguous()
        w = rhs.transpose(1, 2) if trans else rhs.contiguous()
        return _PallasGmm.apply(lhs.contiguous(), w, _offsets_of(group_sizes),
                                trans)

    @staticmethod
    def gmm_dw(lhs, dout, group_sizes):
        return _PallasDw.apply(lhs.contiguous(), dout.contiguous(),
                               _offsets_of(group_sizes))


class PallasFusedBackend(PallasBackend):
    """``pallas`` plus the fused dispatch→GEMM→combine kernel pair for
    whole SwiGLU layers."""

    name = "pallas_fused"

    #: capability flag: ``moe_ffn_blaze`` routes SwiGLU layers through
    #: ``kernels.ops.moe_ffn_blaze_fused``.
    fused_moe = True


_REGISTRY: dict[str, object] = {
    b.name: b for b in (RaggedBackend, SegmentBackend, PallasBackend,
                        PallasFusedBackend)
}


def backend_names() -> list[str]:
    """All registered backend names (available or not)."""
    return list(_REGISTRY)


def available_backends() -> list[str]:
    """Backends that run in this port."""
    return [n for n, b in _REGISTRY.items() if b.available()]


@dataclass(frozen=True)
class ResolvedBackend:
    """A concrete, available backend with the precedence slot that chose it
    (``arg`` | ``context`` | ``config`` | ``env`` | ``auto``) and the
    PyTorch version it was resolved on."""

    name: str
    source: str
    torch_version: str

    def __str__(self) -> str:
        return self.name


def _unset(name) -> bool:
    return name in (None, "", "auto")


def _validate(name: str) -> str:
    if name not in _REGISTRY:
        raise ValueError(
            f"unknown gmm backend {name!r}; known: {backend_names()}")
    backend = _REGISTRY[name]
    if not backend.available():
        raise RuntimeError(
            f"gmm backend {name!r} is not available: "
            f"{getattr(backend, 'reason', '')}; available: "
            f"{available_backends()}")
    return name


@contextlib.contextmanager
def use_backend(name: str | None):
    """Scope the backend for everything run inside the block.  Validated on
    entry; ``None``/"auto" is transparent (inherits an enclosing scope);
    scopes nest and the innermost wins."""
    if _unset(name):
        yield
        return
    _validate(name)
    token = _ACTIVE.set(name)
    try:
        yield
    finally:
        _ACTIVE.reset(token)


def active_backend() -> str | None:
    """The innermost ``use_backend`` scope's name, or None."""
    return _ACTIVE.get()


def resolve(backend: str | ResolvedBackend | None = None, *,
            config: str | None = None) -> ResolvedBackend:
    """Precedence: ``backend`` > active scope > ``config`` >
    ``REPRO_GMM_BACKEND`` > auto.  A ``ResolvedBackend`` is returned
    unchanged."""
    if isinstance(backend, ResolvedBackend):
        return backend
    chain = (("arg", backend),
             ("context", _ACTIVE.get()),
             ("config", config),
             ("env", os.environ.get(ENV_VAR, "").strip() or None))
    for source, cand in chain:
        if not _unset(cand):
            return ResolvedBackend(_validate(cand), source, torch.__version__)
    for cand in _AUTO_PRIORITY:
        if _REGISTRY[cand].available():
            return ResolvedBackend(cand, "auto", torch.__version__)
    raise RuntimeError("no grouped-GEMM backend available")


def get_backend(name: str | ResolvedBackend | None = None):
    """The backend object for ``name`` (or the resolved default)."""
    return _REGISTRY[resolve(name).name]


def gmm(lhs: torch.Tensor, rhs: torch.Tensor, group_sizes: torch.Tensor,
        *, backend: str | ResolvedBackend | None = None) -> torch.Tensor:
    """Grouped matmul (S, d) @ (E, d, h) -> (S, h)."""
    return get_backend(backend).gmm(lhs, rhs, group_sizes)


def gmm_dw(lhs: torch.Tensor, dout: torch.Tensor, group_sizes: torch.Tensor,
           *, backend: str | ResolvedBackend | None = None) -> torch.Tensor:
    """Per-group weight gradient (S, d), (S, h) -> (E, d, h)."""
    return get_backend(backend).gmm_dw(lhs, dout, group_sizes)
