"""Paper-table benchmarks (Figures 3–6 analogues): activation memory and
training-step time, MoEBlaze vs the MegaBlocks-style materialized baseline,
for conf1..conf7 x {SiLU, SwiGLU}.

The port's counterpart of ``repro/bench/paper_tables.py``, with its
implementations, configs (float32, h = 4d) and rows.  Every layer runs the
port's kernel path: the dispatch build of ``kernels/dispatch.py`` and the
``pallas`` grouped-GEMM backend (the hand-written gather-GMM and
``gmm_dw`` kernels on the card, their plain versions on CPU tensors).

Activation memory is measured at the paper's FULL tensor sizes without
computing anything, on fake tensors (the kernel wrappers record their
calls under ``kernels._lib.dry_run`` instead of launching):
  * saved-residual bytes via ``compat.saved_residual_nbytes`` (what the
    graph holds for its backward), parameters excluded — fake CUDA
    tensors through the kernels where PyTorch has a card, fake CPU ones
    through ``segment`` where it has none;
  * the ``temp_bytes`` of the whole fwd+bwd step (``compat.trace_step``;
    corroboration) — the fake step's backward needs PyTorch with a card.

Step time is wall time: on the card at the paper's full sizes
(``seq_scale=1.0``), on the CPU at the reference's 128-row slabs (a
directional proxy only).
"""

from __future__ import annotations

import torch

from repro_torch.bench.timing import median_time_us
from repro_torch.compat import saved_residual_nbytes
from repro_torch.configs.paper_tables import PAPER_TABLE1
from repro_torch.core.baseline import moe_ffn_megablocks
from repro_torch.core.device import resolve_device
from repro_torch.core.moe_layer import moe_ffn_blaze
from repro_torch.core.routing import (build_dispatch, build_dispatch_sort,
                                      top_k_gating)

IMPLS = ("blaze", "blaze_min", "blaze_x", "megablocks")

#: residual mode per blaze impl (see core/moe_layer.py): paper-faithful,
#: recompute-Y_swi, and the deepest recompute-A/B point a
#: ``moe:recompute=ffn_a,ffn_b`` checkpoint plan selects.
_RESIDUALS = {"blaze": "ab_yswi", "blaze_min": "ab", "blaze_x": "x"}

#: the grouped-GEMM backend every layer runs: the hand-written kernels
BACKEND = "pallas"


def _layer_fn(impl: str, act: str, E: int, k: int, backend: str = BACKEND):
    from repro_torch.kernels.dispatch import build_dispatch as build_kernel

    def f(x, w1, w2, w3, wg):
        g = top_k_gating(x, wg, k)
        disp = build_kernel(g.topk_experts.contiguous(), E)
        gates = g.topk_weights.to(x.dtype)
        w2_ = w2 if act == "swiglu" else None
        if impl == "megablocks":
            y = moe_ffn_megablocks(x, gates, disp, w1, w3, w2_,
                                   activation=act, backend=backend)
        else:
            y = moe_ffn_blaze(x, gates, disp, w1, w3, w2_, activation=act,
                              residuals=_RESIDUALS[impl], backend=backend)
        return (y.float() ** 2).sum()
    return f


def _args(conf, *, seq_scale: float = 1.0, dtype=torch.float32,
          device="cuda", abstract: bool = True):
    """The layer's five inputs requiring gradients: empty ones (call under
    ``FakeTensorMode`` for fake tensors) or drawn from seed 0."""
    d, E, k, B, S = conf
    h = 4 * d
    L = max(int(B * S * seq_scale), 64)
    shapes = [(L, d), (E, d, h), (E, d, h), (E, h, d), (d, E)]
    if abstract:
        return [torch.empty(s, dtype=dtype, device=device).requires_grad_()
                for s in shapes]
    gen = torch.Generator().manual_seed(0)
    return [(torch.randn(s, generator=gen) * 0.05).to(device, dtype)
            .requires_grad_() for s in shapes]


def residual_bytes(conf, impl: str, act: str) -> int:
    """Activation bytes saved for backward (params excluded), full size, on
    fake tensors: CUDA ones through the kernels' wrappers where PyTorch
    has a card, else CPU ones through ``segment`` (a CPU-only build aborts
    autograd on a fake CUDA tensor; the saved set is the layer's, not the
    backend's)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels import _lib
    d, E, k, B, S = conf
    card = torch.cuda.is_available()
    f = _layer_fn(impl, act, E, k, BACKEND if card else "segment")
    with FakeTensorMode(), _lib.dry_run():
        return saved_residual_nbytes(
            f, *_args(conf, device="cuda" if card else "cpu"))


def temp_bytes(conf, impl: str, act: str) -> int:
    """The fwd+bwd step's temp bytes at full size (``compat.trace_step`` on
    fake CUDA tensors).  Needs PyTorch with a card: a CPU-only build aborts
    a fake CUDA backward."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.compat import trace_step
    from repro_torch.bench.timing import _leaves_grad
    if not torch.cuda.is_available():
        raise RuntimeError("paper_tables.temp_bytes traces a fake CUDA "
                           "backward, which needs PyTorch with a card")
    d, E, k, B, S = conf
    grad_f = _leaves_grad(_layer_fn(impl, act, E, k), 5)
    with FakeTensorMode():
        return trace_step(grad_f, *_args(conf))[1].temp_bytes


def step_time_us(conf, impl: str, act: str, *, seq_scale: float,
                 iters: int = 3, device=None) -> float:
    from repro_torch.bench.timing import _leaves_grad
    dev = resolve_device(device)
    d, E, k, B, S = conf
    grad_f = _leaves_grad(_layer_fn(impl, act, E, k), 5)
    args = _args(conf, seq_scale=seq_scale, device=dev, abstract=False)
    return median_time_us(grad_f, *args, warmup=1, iters=iters)


def dispatch_build_us(conf, method: str, iters: int = 10,
                      device=None) -> float:
    """Dispatch-structure construction time at FULL L·k (paper §6.4 factor
    2: the dispatch pipeline cost).  ``sortfree`` and ``sort`` are the
    plain PyTorch builds, ``pallas`` the hand-written dispatch kernel
    (its plain version on CPU tensors)."""
    from repro_torch.kernels.dispatch import build_dispatch as build_kernel
    dev = resolve_device(device)
    d, E, k, B, S = conf
    L = B * S
    gen = torch.Generator().manual_seed(0)
    scores = torch.randn(L, E, generator=gen).to(dev)
    topk = torch.topk(scores, k).indices.to(torch.int32).contiguous()
    builders = {"sortfree": build_dispatch, "sort": build_dispatch_sort,
                "pallas": build_kernel}
    fn = builders[method]
    return median_time_us(lambda t: fn(t, E), topk, warmup=1, iters=iters)


def run(print_fn=print, *, quick: bool = False, device=None):
    """Emit CSV rows: name,us_per_call,derived.  On the card the step time
    runs at the paper's full sizes; on the CPU at 128-row slabs."""
    dev = resolve_device(device)
    rows = []
    confs = list(PAPER_TABLE1.items())
    if quick:
        confs = confs[:2]
    for name, conf in confs:
        for act in ("silu", "swiglu"):
            mems = {}
            for impl in IMPLS:
                mems[impl] = residual_bytes(conf, impl, act)
                rows.append((f"mem_{name}_{act}_{impl}", 0.0,
                             f"residual_MB={mems[impl]/1e6:.1f}"))
            ratio = mems["megablocks"] / max(mems["blaze"], 1)
            ratio_min = mems["megablocks"] / max(mems["blaze_min"], 1)
            rows.append((f"memratio_{name}_{act}", 0.0,
                         f"megablocks/blaze={ratio:.2f}x "
                         f"megablocks/blaze_min={ratio_min:.2f}x"))
            print_fn(f"{name} {act}: blaze={mems['blaze']/1e6:.0f}MB "
                     f"megablocks={mems['megablocks']/1e6:.0f}MB "
                     f"ratio={ratio:.2f}x (min-variant {ratio_min:.2f}x)")
        scale = 1.0 if dev.type == "cuda" else 128 / (conf[3] * conf[4])
        for act in ("silu", "swiglu"):
            ts = {impl: step_time_us(conf, impl, act, seq_scale=scale,
                                     iters=1, device=dev)
                  for impl in ("blaze", "megablocks")}
            sp = ts["megablocks"] / ts["blaze"]
            rows.append((f"steptime_{name}_{act}_blaze", ts["blaze"],
                         f"speedup_vs_megablocks={sp:.2f}x@scale={scale:.4f}"))
            print_fn(f"{name} {act}: step blaze={ts['blaze']:.0f}us "
                     f"mega={ts['megablocks']:.0f}us speedup={sp:.2f}x")
        # dispatch build at full L·k
        for method in ("sortfree", "sort", "pallas"):
            us = dispatch_build_us(conf, method, iters=3 if not quick else 2,
                                   device=dev)
            rows.append((f"dispatch_{name}_{method}", us,
                         f"L={conf[3]*conf[4]}"))
            print_fn(f"{name}: dispatch[{method}] {us:.0f}us")
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return rows
