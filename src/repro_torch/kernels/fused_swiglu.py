"""Fused dense SwiGLU: the forward dual GEMM with its epilogue and the two
backward kernels (CUDA), each beside its plain version.

Replaces ``repro/kernels/fused_swiglu.py``:

- ``fused_swiglu_fwd`` (``_fwd_kernel``): ``a = x w1``, ``b = x w2`` with
  float32 accumulators, ``y = silu(a) b``; y, a and b rounded once to
  ``x.dtype``;
- ``fused_swiglu_bwd_x`` (``_bwd_x_kernel``): ``da = dy b silu'(a)``,
  ``db = dy silu(a)`` in float32, each rounded to ``dy.dtype``;
  ``dx = da w1ᵀ + db w2ᵀ`` in one float32 accumulator, rounded once;
- ``fused_swiglu_bwd_w`` (``_bwd_w_kernel``): the same da, db rounded to
  ``x.dtype``; ``dw1 = xᵀ da``, ``dw2 = xᵀ db``, in ``x.dtype``.

The plain versions follow those rounding points (``repro/kernels/ref.py``
rounds bwd_x's two products to bf16 before summing them; the Pallas
kernel, and so the port, sums them in float32).

Bound on the card: operations at prefill and in training (4 L d h each),
bytes at decode (the weights).  ``csrc/fused_swiglu.cu`` runs the three
in bf16 as Hopper kernels, TMA feeding ``wgmma``, each block walking the
contraction itself (the TPU carries float32 scratch across an ordered grid
axis); see the source for the tiling.  The forward is persistent and
warp-specialized, x and w1 | w2 both read by ``wgmma`` from shared memory;
at decode (L <= 16), when its 128 x 128 tiles leave a partial last wave
(136 tiles for 132 SMs at Qwen3-14B's width), :func:`fwd_plan` has the
partial wave's contraction split over several SMs, and the pieces are
summed in a fixed order (two runs give the same bits).  ``bwd_x`` forms
da and db in registers and ``bwd_w`` in shared memory; neither allocates
beyond its outputs.  Any L, d and h; float32 and widths that are not a
multiple of 8 take a plain float32-FMA tiled kernel.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _lib, cost


def _silu(a: torch.Tensor) -> torch.Tensor:
    return a * torch.sigmoid(a)


def _dsilu(a: torch.Tensor) -> torch.Tensor:
    s = torch.sigmoid(a)
    return s * (1.0 + a * (1.0 - s))


def swiglu_grads(dy: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                 dtype: torch.dtype):
    """``(da, db)`` in float32 from ``dy``, ``a``, ``b``, each rounded to
    ``dtype`` (the tensor-core operands of the backward kernels)."""
    dyf, af, bf = dy.float(), a.float(), b.float()
    return (dyf * bf * _dsilu(af)).to(dtype), (dyf * _silu(af)).to(dtype)


def fused_swiglu_fwd_plain(x: torch.Tensor, w1: torch.Tensor,
                           w2: torch.Tensor):
    """Plain version of the forward: ``(y, a, b)`` in ``x.dtype``."""
    xf = x.float()
    a = xf @ w1.float()
    b = xf @ w2.float()
    dt = x.dtype
    return (_silu(a) * b).to(dt), a.to(dt), b.to(dt)


def fused_swiglu_bwd_x_plain(dy: torch.Tensor, a: torch.Tensor,
                             b: torch.Tensor, w1: torch.Tensor,
                             w2: torch.Tensor) -> torch.Tensor:
    """Plain version of bwd_x: ``dx`` (L, d) in ``dy.dtype``."""
    da, db = swiglu_grads(dy, a, b, dy.dtype)
    dx = da.float() @ w1.float().T + db.float() @ w2.float().T
    return dx.to(dy.dtype)


def fused_swiglu_bwd_w_plain(x: torch.Tensor, dy: torch.Tensor,
                             a: torch.Tensor, b: torch.Tensor):
    """Plain version of bwd_w: ``(dw1, dw2)`` (d, h) in ``x.dtype``."""
    da, db = swiglu_grads(dy, a, b, x.dtype)
    xt = x.float().T
    return (xt @ da.float()).to(x.dtype), (xt @ db.float()).to(x.dtype)


def _require_all(pairs, dtype, device) -> None:
    if dtype not in _lib.DTYPE_CODE:
        raise ValueError(f"fused SwiGLU takes float32 or bfloat16, got "
                         f"{dtype}")
    for name, t in pairs:
        _lib.require(t, name, dtype=dtype, ndim=2, device=device)


def _shape_check(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(f"fused SwiGLU: bad shapes, {what}")


FWD_BM, FWD_BN, FWD_BK = 128, 128, 64   # the bf16 forward's tile and step
FWD_SPLIT_MAX = 8                        # pieces of a split tile, at most
FWD_SPLIT_ROWS = 16                      # rows of x up to which it splits


def fwd_plan(L: int, d: int, h: int, n_sm: int) -> tuple[int, int]:
    """``(grid, tail)`` of the bf16 forward kernel: one persistent block
    per SM, fewer when there is less work.  At decode (L <=
    ``FWD_SPLIT_ROWS``), when the 128 x 128 tiles leave a partial last
    wave, the whole waves run as they are and ``tail`` blocks share the
    partial wave's (tile, k-step) pairs evenly, each tile in at most
    ``FWD_SPLIT_MAX`` pieces (stream-K); ``tail`` is 0 otherwise.  At
    Qwen3-14B's widths on an H100 80GB HBM3 at 700 W (``tools/kernel_ab.py``
    against a copy that never splits) a call took 0.1449 and 0.1557 ms at
    L = 4 and 16 against 0.1688 and 0.1716 with whole tiles only; at
    L = 64 summing the pieces cost more than the split saved."""
    tiles = -(-L // FWD_BM) * -(-h // FWD_BN)
    nk = -(-d // FWD_BK)
    if tiles == 0 or nk == 0:
        return 0, 0
    rest = tiles % n_sm
    if L > FWD_SPLIT_ROWS or nk < 2 or rest == 0:
        return min(n_sm, tiles), 0
    tail = min(n_sm, rest * min(nk, FWD_SPLIT_MAX))
    return (n_sm if tiles > n_sm else tail), tail


_SM_COUNT: dict = {}
_SPLIT_COUNTS: dict = {}


def _sm_count(device: torch.device) -> int:
    if device not in _SM_COUNT:
        _SM_COUNT[device] = _lib.sm_count(device)
    return _SM_COUNT[device]


def _split_counts(device: torch.device, n_sm: int) -> torch.Tensor:
    """The split plan's counters on ``device``: 2 ints for each tile of a
    partial wave (fewer than ``n_sm``), zero, made once (the kernel leaves
    them zero); the port launches on one stream, so calls never share
    them."""
    if device not in _SPLIT_COUNTS:
        _SPLIT_COUNTS[device] = torch.zeros(2 * n_sm, dtype=torch.int32,
                                            device=device)
    return _SPLIT_COUNTS[device]


def fused_swiglu_fwd(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor):
    """x: (L, d); w1, w2: (d, h).  Returns ``(y, a, b)``, each (L, h) in
    ``x.dtype``.  A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel (counted in ``fused_swiglu_fwd.launches``)."""
    if not x.is_cuda:
        return fused_swiglu_fwd_plain(x, w1, w2)
    _require_all((("x", x), ("w1", w1), ("w2", w2)), x.dtype, x.device)
    L, d = x.shape
    h = w1.shape[1]
    _shape_check(w1.shape == (d, h) and w2.shape == (d, h),
                 f"x {tuple(x.shape)}, w1 {tuple(w1.shape)}, "
                 f"w2 {tuple(w2.shape)}")
    y = torch.empty(L, h, dtype=x.dtype, device=x.device)
    a, b = torch.empty_like(y), torch.empty_like(y)
    n_sm = _sm_count(x.device)
    grid, tail = fwd_plan(L, d, h, n_sm)
    ws = counts = None
    if tail and x.dtype == torch.bfloat16:
        ws = torch.empty(2 * tail * L * 2 * FWD_BN, dtype=torch.float32,
                         device=x.device)
        # a dry run's fake counters are its own, never the cached ones
        counts = (torch.zeros(2 * n_sm, dtype=torch.int32, device=x.device)
                  if _lib.is_dry() else _split_counts(x.device, n_sm))
    if _lib.dry("fused_swiglu_fwd", cost.fused_swiglu(L, d, h), (x, w1, w2),
                (y, a, b)):
        return y, a, b
    code = _lib.lib().repro_fused_swiglu_fwd(
        _lib.DTYPE_CODE[x.dtype], x.data_ptr(), w1.data_ptr(), w2.data_ptr(),
        y.data_ptr(), a.data_ptr(), b.data_ptr(),
        None if ws is None else ws.data_ptr(),
        None if counts is None else counts.data_ptr(), L, d, h, grid,
        tail if ws is not None else 0, _lib.stream_ptr(x))
    _lib.check("repro_fused_swiglu_fwd", code)
    fused_swiglu_fwd.launches += 1
    return y, a, b


def fused_swiglu_bwd_x(dy: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                       w1: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """dy, a, b: (L, h); w1, w2: (d, h).  Returns dx (L, d) in
    ``dy.dtype``.  A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel (counted in ``fused_swiglu_bwd_x.launches``)."""
    if not dy.is_cuda:
        return fused_swiglu_bwd_x_plain(dy, a, b, w1, w2)
    _require_all((("dy", dy), ("a", a), ("b", b), ("w1", w1), ("w2", w2)),
                 dy.dtype, dy.device)
    L, h = dy.shape
    d = w1.shape[0]
    _shape_check(a.shape == (L, h) and b.shape == (L, h)
                 and w1.shape == (d, h) and w2.shape == (d, h),
                 f"dy {tuple(dy.shape)}, a {tuple(a.shape)}, "
                 f"b {tuple(b.shape)}, w1 {tuple(w1.shape)}, "
                 f"w2 {tuple(w2.shape)}")
    dx = torch.empty(L, d, dtype=dy.dtype, device=dy.device)
    if _lib.dry("fused_swiglu_bwd_x", cost.fused_swiglu(L, d, h),
                (dy, a, b, w1, w2), (dx,)):
        return dx
    code = _lib.lib().repro_fused_swiglu_bwd_x(
        _lib.DTYPE_CODE[dy.dtype], dy.data_ptr(), a.data_ptr(), b.data_ptr(),
        w1.data_ptr(), w2.data_ptr(), dx.data_ptr(), L, d, h,
        _lib.stream_ptr(dy))
    _lib.check("repro_fused_swiglu_bwd_x", code)
    fused_swiglu_bwd_x.launches += 1
    return dx


def fused_swiglu_bwd_w(x: torch.Tensor, dy: torch.Tensor, a: torch.Tensor,
                       b: torch.Tensor):
    """x: (L, d); dy, a, b: (L, h).  Returns ``(dw1, dw2)``, each (d, h)
    in ``x.dtype``.  A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel (counted in ``fused_swiglu_bwd_w.launches``)."""
    if not x.is_cuda:
        return fused_swiglu_bwd_w_plain(x, dy, a, b)
    _require_all((("x", x), ("dy", dy), ("a", a), ("b", b)), x.dtype,
                 x.device)
    L, d = x.shape
    h = dy.shape[1]
    _shape_check(dy.shape == (L, h) and a.shape == (L, h)
                 and b.shape == (L, h),
                 f"x {tuple(x.shape)}, dy {tuple(dy.shape)}, "
                 f"a {tuple(a.shape)}, b {tuple(b.shape)}")
    dw1 = torch.empty(d, h, dtype=x.dtype, device=x.device)
    dw2 = torch.empty_like(dw1)
    if _lib.dry("fused_swiglu_bwd_w", cost.fused_swiglu(L, d, h),
                (x, dy, a, b), (dw1, dw2)):
        return dw1, dw2
    code = _lib.lib().repro_fused_swiglu_bwd_w(
        _lib.DTYPE_CODE[x.dtype], x.data_ptr(), dy.data_ptr(), a.data_ptr(),
        b.data_ptr(), dw1.data_ptr(), dw2.data_ptr(), L, d, h,
        _lib.stream_ptr(x))
    _lib.check("repro_fused_swiglu_bwd_w", code)
    fused_swiglu_bwd_w.launches += 1
    return dw1, dw2


fused_swiglu_fwd.launches = 0
fused_swiglu_bwd_x.launches = 0
fused_swiglu_bwd_w.launches = 0
