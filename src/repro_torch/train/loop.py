"""Training step and loop.

Mirrors ``repro/train/loop.py``: ``make_train_step`` (single device,
without the mesh, the simulated peak and the budget fit) and ``train``
(without checkpoint saving).  A step is value-and-grad of
``train_loss``, global-norm clipping, the cosine schedule and AdamW.
PyTorch runs eagerly, so there is nothing to compile; the step updates
the parameters and the optimizer state in place and returns them.

The grouped-GEMM backend (``moe_impl="blaze"``) is resolved once per step
function, as in the reference: call-site argument > active
``use_backend`` scope > ``tcfg.gmm_backend`` > ``cfg.gmm_backend`` >
``REPRO_GMM_BACKEND`` > auto; each step runs inside ``use_backend`` of
that name.
"""

from __future__ import annotations

import time

import torch
from torch.profiler import record_function

from repro_torch.core import gmm_backend as GB
from repro_torch.core.device import resolve_device
from repro_torch.data.pipeline import make_batch_iterator
from repro_torch.interop import init_params
from repro_torch.models import transformer as T
from repro_torch.models.moe_block import check_supported as check_moe
from repro_torch.train.optimizer import (AdamWState, adamw_update,
                                         clip_by_global_norm,
                                         cosine_schedule, init_adamw,
                                         tree_leaves)


def batch_to_device(batch: dict, device: torch.device) -> dict:
    """numpy (or torch) batch arrays -> tensors on ``device``."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def _config_backend(cfg, tcfg) -> str:
    """The config slot of the precedence chain: the train config's choice
    wins over the model config's."""
    if tcfg.gmm_backend not in (None, "", "auto"):
        return tcfg.gmm_backend
    return cfg.gmm_backend


def make_train_step(cfg, tcfg, device=None, backend=None):
    """Returns ``step_fn(params, opt_state, batch) -> (params, opt_state,
    metrics)``.  ``batch`` holds ``tokens`` and ``labels`` (B, S) as numpy
    arrays or tensors; ``params`` is the port's parameter tree of float32
    masters (``interop.init_params(..., dtype=torch.float32)``), updated in
    place with ``opt_state``.  The metrics are 0-d tensors on the device
    (``loss``, ``ce``, ``aux``, ``grad_norm``) and the float ``lr``.  The
    resolved grouped-GEMM backend is ``step_fn.resolved_backend``."""
    dev = resolve_device(device)
    resolved = GB.resolve(backend, config=_config_backend(cfg, tcfg))
    cfg = cfg.replace(gmm_backend=resolved.name)
    T.check_supported(cfg)
    check_moe(cfg)
    if tcfg.num_microbatches > 1:
        raise NotImplementedError(
            "num_microbatches > 1 (gradient accumulation) is not ported "
            "(ROADMAP queue A1)")

    def _step(params, opt_state: AdamWState, batch):
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        # Spans that name the step's parts in a profiler trace (no cost
        # without a profiler).  The backward's kernels are launched from
        # autograd's own thread, so a trace does not attribute them to the
        # backward span.
        with record_function("train_step.forward"):
            loss, metrics = T.train_loss(
                params, batch_to_device(batch, dev), cfg)
        with record_function("train_step.backward"):
            grads = list(torch.autograd.grad(loss, leaves))
        with record_function("train_step.optimizer"):
            gnorm = clip_by_global_norm(grads, tcfg.grad_clip)
            lr = cosine_schedule(opt_state.step, peak_lr=tcfg.learning_rate,
                                 warmup=tcfg.warmup_steps,
                                 total=tcfg.total_steps)
            opt_state = adamw_update(grads, opt_state, leaves, lr=lr,
                                     b1=tcfg.b1, b2=tcfg.b2, eps=tcfg.eps,
                                     weight_decay=tcfg.weight_decay)
        return params, opt_state, {
            "loss": loss.detach(), "ce": metrics["ce"].detach(),
            "aux": metrics["aux"].detach(), "grad_norm": gnorm, "lr": lr}

    def step_fn(params, opt_state: AdamWState, batch):
        with GB.use_backend(resolved.name):
            return _step(params, opt_state, batch)

    step_fn.device = dev
    step_fn.resolved_backend = resolved
    return step_fn


def train(cfg, tcfg, *, device=None, params=None, log=print,
          batch_iterator=None, step_hook=None):
    """End-to-end training loop.  Returns ``(params, opt_state,
    history)``.  Without ``params`` the weights are drawn from
    ``tcfg.seed`` as float32 masters; without ``batch_iterator`` the
    batches come from the synthetic pipeline seeded with ``tcfg.seed``.
    Every step's metrics are read back as floats (which waits for the
    device), with ``step_s`` the step's host time; ``step_hook(step,
    metrics)`` sees each of them, and ``history`` keeps every
    ``log_every``-th step and the last, with the step's ``gmm_backend``."""
    dev = resolve_device(device)
    if params is None:
        gen = torch.Generator(device=dev).manual_seed(tcfg.seed)
        params = init_params(cfg, gen, dev,
                             dtype=getattr(torch, cfg.param_dtype))
    opt_state = init_adamw(params)
    step_fn = make_train_step(cfg, tcfg, dev)
    if batch_iterator is None:
        batch_iterator = make_batch_iterator(
            cfg.vocab_size, tcfg.seq_len, tcfg.batch_size, tcfg.seed)
    history = []
    t0 = time.perf_counter()
    for step in range(tcfg.total_steps):
        batch = next(batch_iterator)
        ts = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        m = {k: float(v) for k, v in metrics.items()}
        m["step_s"] = time.perf_counter() - ts
        if step_hook is not None:
            step_hook(step, m)
        if step % tcfg.log_every == 0 or step == tcfg.total_steps - 1:
            m["step"] = step
            m["gmm_backend"] = step_fn.resolved_backend.name
            m["wall_s"] = time.perf_counter() - t0
            history.append(m)
            log(f"step {step:5d} loss {m['loss']:.4f} ce {m['ce']:.4f} "
                f"gnorm {m['grad_norm']:.3f} lr {m['lr']:.2e} "
                f"({m['wall_s']:.1f}s)")
    return params, opt_state, history
