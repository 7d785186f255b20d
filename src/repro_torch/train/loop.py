"""Training step and loop.

Mirrors ``repro/train/loop.py``: ``make_train_step`` (with gradient
accumulation, the checkpoint-plan resolution, the budget fit and the
simulated peak) and ``train`` (with the backend resolved per step and
periodic checkpoint saving).  A step is value-and-grad of ``train_loss``,
global-norm clipping, the cosine schedule and AdamW.  PyTorch runs
eagerly, so there is nothing to compile; the step updates the parameters
and the optimizer state in place and returns them.

Gradient accumulation (``tcfg.num_microbatches = M > 1``) splits the
global batch along its leading axis into M microbatches, as the reference
does, and runs forward and backward on each in order: the live activations
are one microbatch's.  Each leaf's gradient is divided by M as it arrives
(a tensor hook) and summed into the leaf's ``.grad`` by autograd, so the
float32 sum is the reference's ``acc + g / M`` in microbatch order, and no
second set of gradients is held beside the accumulator: a microbatch's
gradient of a leaf is freed once it is added.  The loss and each metric are the mean
over the microbatches; clipping and AdamW run once, on the sum.

Under a :class:`~repro_torch.launch.mesh.Mesh` every rank runs the step
on its own batch rows (``sharding.batch_specs``) and holds only its block
of every parameter leaf and of its AdamW moments, as the reference's
launcher places them (``sharding.param_specs(..., fsdp=True,
moe_parallel=<the resolved mode>)``, ``step_fn.param_specs``;
``sharding.shard_params`` cuts them).  ``moe_parallel="auto"`` resolves
through the roofline cost model at the live per-shard slab (the
microbatch's rows on one data shard times ``seq_len``), as the
reference's step does.  The forward gathers each leaf whole just before
its use (``sharding.FSDP``); the backward sums a gathered leaf's gradient
over the data axes the batch is split over into this rank's block, and
the gradients of the leaves not split over those axes are summed over
them once, after accumulation.  The step gives the single-device step's
numbers: the loss is the global masked mean, the global norm counts each
element of the global tree once, and AdamW updates the local blocks.
Every rank reports the same metrics.

The grouped-GEMM backend (``moe_impl="blaze"``) is resolved once per step
function, as in the reference: call-site argument > active
``use_backend`` scope > ``tcfg.gmm_backend`` > ``cfg.gmm_backend`` >
``REPRO_GMM_BACKEND`` > auto; each step runs inside ``use_backend`` of
that name.  ``train`` resolves it again at the top of every step and keeps
one step function per backend name, so a scope entered between steps (in
``step_hook``) changes exactly the steps run inside it.  The checkpoint
plan follows the same discipline: call-site ``remat_policy`` >
``cfg.remat_policy`` > ``"none"``, or, with ``hbm_budget``,
``CheckpointPlan.fit`` over the simulated peaks of ``core/memsim.py``.
"""

from __future__ import annotations

import os
import time

import torch
from torch.profiler import record_function

from repro_torch import sharding as SH
from repro_torch.core import checkpoint as CK
from repro_torch.core import gmm_backend as GB
from repro_torch.core import memsim
from repro_torch.core.collectives import all_reduce_
from repro_torch.core.device import resolve_device
from repro_torch.data.pipeline import make_batch_iterator
from repro_torch.interop import init_params, param_shapes
from repro_torch.models import transformer as T
from repro_torch.models.moe_block import check_supported as check_moe
from repro_torch.models.moe_block import resolve_moe_parallel_ex
from repro_torch.train.checkpointing import save_checkpoint
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


def _dp_shards(mesh) -> int:
    """Data-parallel shard count of a mesh (activations are split over
    these axes, so per-device residuals divide by it)."""
    if mesh is None:
        return 1
    n = 1
    for a in ("pod", "data"):
        if a in mesh.axis_names:
            n *= mesh.shape[a]
    return max(n, 1)


def make_train_step(cfg, tcfg, device=None, backend=None, mesh=None, *,
                    remat_policy=None, hbm_budget=None):
    """Returns ``step_fn(params, opt_state, batch) -> (params, opt_state,
    metrics)``.  ``batch`` holds the input kind's arrays (``tokens`` and
    ``labels`` (B, S); ``features`` and ``labels``; or ``image_embeds``,
    ``tokens`` and ``labels``: ``data/pipeline.synthesize_batch``) as numpy
    arrays or tensors; ``params`` is the port's parameter tree of float32
    masters (``interop.init_params(..., dtype=torch.float32)``), updated in
    place with ``opt_state``.  The metrics are 0-d tensors on the device
    (``loss``, ``ce``, ``aux``, ``moe_overflow``, ``grad_norm``) and the
    float ``lr``; with ``tcfg.num_microbatches > 1`` the first four are
    means over the microbatches (which need float32 leaves: the sum
    accumulates in the leaves' ``.grad``).  The resolved grouped-GEMM
    backend is ``step_fn.resolved_backend``.

    The checkpoint plan is ``remat_policy`` (a name, spec or plan) over
    ``cfg.remat_policy`` over the default, as ``step_fn.resolved_plan``
    (a ``ResolvedPlan``).  ``hbm_budget`` (bytes per device) picks the
    plan by ``CheckpointPlan.fit`` instead (``remat_policy`` becomes the
    preferred candidate), at the live set of one device: the global batch
    divided by the microbatch count and by the mesh's data-parallel
    shards.  ``step_fn.peak_sim_bytes``
    is the simulated per-device step peak under the resolved plan
    (``core/memsim.py``, ``base="train"``).

    With a ``mesh``, ``batch`` is the global batch (each rank takes its
    rows) and ``params`` this rank's blocks,
    ``sharding.shard_params(whole, mesh, step_fn.param_specs)``; the
    AdamW state is ``init_adamw`` of them (its moments mirror the blocks,
    ``sharding.opt_specs``).  ``step_fn(..., local_batch=True)`` takes
    ``batch`` as this rank's rows already (its block under
    ``sharding.batch_specs`` of the global batch of ``tcfg.batch_size``
    rows), as the dry run places it: each microbatch is then its
    ``1/M`` of those rows.  ``step_fn.moe_decision`` is the mode's
    ``roofline.ParallelDecision``."""
    dev = resolve_device(device)
    resolved = GB.resolve(backend, config=_config_backend(cfg, tcfg))
    cfg = cfg.replace(gmm_backend=resolved.name)
    n_micro = max(tcfg.num_microbatches, 1)
    b_live = max(tcfg.batch_size // n_micro // _dp_shards(mesh), 1)
    mode, decision, specs = "single", None, None
    if mesh is not None:
        # an invalid (mode, mesh) pairing raises here, at construction;
        # 'auto' resolves at the live per-shard slab, as moe_sublayer does
        if cfg.is_moe:
            decision = resolve_moe_parallel_ex(cfg, mesh,
                                               b_live * tcfg.seq_len)
            mode = decision.mode
        specs = SH.param_specs(param_shapes(cfg), mesh, fsdp=True,
                               moe_parallel=(mode if cfg.is_moe
                                             else "auto"))

    if hbm_budget is not None:
        prefer = (CK.get_plan(remat_policy) if remat_policy is not None
                  else None)
        resolved_plan = CK.CheckpointPlan.fit(
            cfg, b_live * tcfg.seq_len, hbm_budget, batch=b_live,
            prefer=prefer, **_sim_mesh(cfg, mesh, mode)).resolved
    else:
        resolved_plan = CK.resolve_plan(remat_policy,
                                        config=cfg.remat_policy)
    cfg = cfg.replace(remat_policy=resolved_plan.spec)
    T.check_supported(cfg)
    if cfg.is_moe:
        check_moe(cfg)

    def _step(params, opt_state: AdamWState, batch, local_batch):
        leaves = tree_leaves(params)
        split = (None if mesh is None else
                 [SH.split_axes(sp, mesh)
                  for sp in SH.spec_leaves(specs, params)])
        if n_micro > 1 and any(p.dtype != torch.float32 for p in leaves):
            raise ValueError("gradient accumulation sums in the leaves' "
                             ".grad and takes float32 leaves only")
        for p in leaves:
            p.requires_grad_(True)
            p.grad = None
        # each leaf's gradient divided by M on its way into .grad, where
        # autograd adds it to the sum of the microbatches before it
        hooks = ([p.register_hook(lambda g: g / n_micro) for p in leaves]
                 if n_micro > 1 else [])
        per_micro, dp = [], ()
        try:
            for mb in _microbatches(batch, n_micro):
                fsdp = None
                if mesh is not None and local_batch:
                    dp = SH.batch_axes(mesh, tcfg.batch_size // n_micro)
                elif mesh is not None:
                    dp = SH.batch_axes(mesh, mb["labels"].shape[0])
                    mb = SH.local_batch(mb, SH.batch_specs(mb, mesh), mesh)
                if mesh is not None:
                    fsdp = SH.FSDP(mesh, specs, dp,
                                   getattr(torch, cfg.dtype))
                # Spans that name the step's parts in a profiler trace (no
                # cost without a profiler).  The backward's kernels are
                # launched from autograd's own thread, so a trace does not
                # attribute them to the backward span.
                with record_function("train_step.forward"):
                    loss, metrics = T.train_loss(
                        params, batch_to_device(mb, dev), cfg, mesh=mesh,
                        dp_axes=dp, fsdp=fsdp)
                with record_function("train_step.backward"):
                    torch.autograd.backward(loss, inputs=leaves)
                per_micro.append({k: v.detach() for k, v in metrics.items()})
                del loss, metrics
        finally:
            for hk in hooks:
                hk.remove()
        grads = [p.grad for p in leaves]
        for p in leaves:
            p.grad = None
        with record_function("train_step.optimizer"):
            if mesh is not None:
                # a gathered leaf's gradient was summed over the batch
                # axes it is split over in the backward; over the rest, here
                for g, axes in zip(grads, split):
                    rest = tuple(a for a in dp if a not in axes)
                    if rest:
                        all_reduce_(g, mesh.group(rest))
            gnorm = clip_by_global_norm(
                grads, tcfg.grad_clip, split=split, mesh=mesh)
            lr = cosine_schedule(opt_state.step, peak_lr=tcfg.learning_rate,
                                 warmup=tcfg.warmup_steps,
                                 total=tcfg.total_steps)
            opt_state = adamw_update(grads, opt_state, leaves, lr=lr,
                                     b1=tcfg.b1, b2=tcfg.b2, eps=tcfg.eps,
                                     weight_decay=tcfg.weight_decay)
        mean = lambda vals: torch.stack(vals).mean()
        return params, opt_state, {
            "loss": mean([m["ce"] + m["aux"] for m in per_micro]),
            **{k: mean([m[k] for m in per_micro])
               for k in ("ce", "aux", "moe_overflow")},
            "grad_norm": gnorm, "lr": lr}

    def step_fn(params, opt_state: AdamWState, batch, *,
                local_batch: bool = False):
        with GB.use_backend(resolved.name):
            return _step(params, opt_state, batch, local_batch)

    step_fn.device = dev
    step_fn.resolved_backend = resolved
    step_fn.resolved_plan = resolved_plan
    step_fn.peak_sim_bytes = memsim.simulate_peak(
        cfg, b_live * tcfg.seq_len, batch=b_live, plan=resolved_plan.plan,
        base="train", **_sim_mesh(cfg, mesh, mode))
    step_fn.moe_parallel = mode
    step_fn.moe_decision = decision
    step_fn.mesh = mesh
    step_fn.param_specs = specs
    return step_fn


def traceable_step(cfg, tcfg, device, *, mesh=None, backend=None):
    """``(step_fn, make_args)``: ``make_train_step(cfg, tcfg, device,
    backend=backend, mesh=mesh)`` and a function that, called under
    ``FakeTensorMode``, gives its ``(args, kwargs)`` as fake tensors on
    ``device``: float32 masters of ``init_params``' shapes, their AdamW
    moments and a batch of ``tcfg``'s shape; under a ``mesh`` this rank's
    blocks under ``step_fn.param_specs`` and its rows of the batch
    (``local_batch=True``).  What the dry run traces for a training
    step."""
    from repro_torch.compat import empty_tree
    from repro_torch.configs.base import InputShape
    from repro_torch.launch.specs import batch_shapes
    step_fn = make_train_step(cfg, tcfg, device, backend=backend, mesh=mesh)
    whole = init_params(cfg, device="meta",
                        dtype=getattr(torch, cfg.param_dtype))
    batch = batch_shapes(cfg, InputShape("step", tcfg.seq_len,
                                         tcfg.batch_size, "train"))
    if mesh is not None:
        whole = SH.shard_params(whole, mesh, step_fn.param_specs)
        batch = SH.local_batch(batch, SH.batch_specs(batch, mesh), mesh)

    def make_args():
        params = empty_tree(whole, device)
        return ((params, init_adamw(params), empty_tree(batch, device)),
                {"local_batch": True} if mesh is not None else {})
    return step_fn, make_args


def compiled_step_memory(cfg, tcfg, *, mesh=None, backend=None,
                         device=None, real: bool = False) -> dict:
    """The memory and cost of one training step without running it: the
    counterpart of the reference's hook (``repro/train/loop.py:169-192``,
    which ``repro/bench/memory.py`` reads), with its keys but
    ``compiled``.  The step of ``make_train_step(cfg, tcfg, device,
    backend=backend, mesh=mesh)`` is traced on fake tensors
    (``compat.trace_step``): float32 masters from ``init_params``, AdamW
    moments and a batch of ``tcfg``'s shape, on ``device`` (the card
    unless the caller names the CPU); no array is allocated and no kernel
    is launched (the wrappers record their calls).  Under a ``mesh``
    (a ``launch.mesh.DryMesh``) the parameters and moments are this
    rank's blocks under ``step_fn.param_specs`` and the batch its rows.
    ``real`` traces real tensors of the same shapes instead (zeros), for a
    backend that cannot run on fake ones (``segment`` reads the routed
    counts to the host); the accounting is the same, and the kernels
    launch.

    Returns the reference's ``arg_bytes``, ``out_bytes``, ``temp_bytes``,
    ``alias_bytes``, ``gmm_backend`` and ``remat_plan``, and beside them
    ``peak_bytes``, ``flops``, ``bytes_accessed``, ``kernels`` (per kernel
    its launches, operations and bytes: fake CUDA tensors only),
    ``collective_counts`` / ``collective_bytes_by_kind`` and
    ``trace_s``."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.compat import _tensors, trace_step
    step_fn, make_args = traceable_step(cfg, tcfg, resolve_device(device),
                                        mesh=mesh, backend=backend)
    if real:
        args, kwargs = make_args()
        with torch.no_grad():
            for t in _tensors((args, kwargs)):
                t.zero_()
        _, tr = trace_step(step_fn, *args, **kwargs)
    else:
        with FakeTensorMode():
            args, kwargs = make_args()
            _, tr = trace_step(step_fn, *args, **kwargs)
    return {"arg_bytes": tr.arg_bytes, "out_bytes": tr.out_bytes,
            "temp_bytes": tr.temp_bytes, "alias_bytes": tr.alias_bytes,
            "gmm_backend": step_fn.resolved_backend.name,
            "remat_plan": step_fn.resolved_plan.spec,
            "peak_bytes": tr.peak_bytes, "flops": tr.flops,
            "bytes_accessed": tr.bytes_accessed, "kernels": tr.kernels,
            "collective_counts": tr.collectives.counts(),
            "collective_bytes_by_kind": tr.collectives.bytes_by_kind(),
            "trace_s": tr.seconds}


def _microbatches(batch: dict, n: int):
    """The batch's ``n`` equal pieces along its leading axis, in order
    (every entry: tokens, labels, frame or image embeddings)."""
    rows = batch["labels"].shape[0]
    if rows % n:
        raise ValueError(f"a batch of {rows} rows does not split into "
                         f"{n} microbatches")
    size = rows // n
    for i in range(n):
        yield {k: v[i * size:(i + 1) * size] for k, v in batch.items()}


def _sim_mesh(cfg, mesh, mode: str) -> dict:
    """The simulator's distribution arguments for the resolved MoE mode
    (``mode=None`` lets it pick ``single`` on one device, as the
    reference's dense configs do)."""
    if mesh is None:
        return {"mode": "single" if cfg.is_moe else None}
    return {"mode": mode if cfg.is_moe else None,
            "n_model": max(mesh.shape.get("model", 1), 1),
            "n_node": max(mesh.shape.get("node", 1), 1)}


def train(cfg, tcfg, *, device=None, params=None, log=print,
          batch_iterator=None, step_hook=None, mesh=None):
    """End-to-end training loop.  Returns ``(params, opt_state,
    history)``.  Without ``params`` the weights are drawn from
    ``tcfg.seed`` as float32 masters; without ``batch_iterator`` the
    batches come from the synthetic pipeline seeded with ``tcfg.seed``.

    The grouped-GEMM backend is resolved at the top of every step (a
    ``use_backend`` scope entered between steps, e.g. in ``step_hook``,
    retargets the next step); the step functions are kept per backend
    name.  Every step's metrics are read back as floats (which waits for
    the device), with ``step_s`` the step's host time, ``gmm_backend``,
    ``remat_plan`` (the canonical spec of the step's checkpoint plan) and
    ``peak_sim_bytes`` (its simulated per-device peak); ``step_hook(step,
    metrics)`` sees each of them, and ``history`` keeps every
    ``log_every``-th step and the last.  With ``tcfg.checkpoint_every``
    the parameters and the optimizer state are saved after every such
    step but the first, to ``<checkpoint_dir>/step_<step>``
    (``train/checkpointing.py``), as the reference saves them.

    With a ``mesh`` every rank draws the same whole parameters (or takes
    ``params``, the whole tree) and keeps its blocks under the step's
    ``param_specs``; the returned ``params`` and optimizer state are this
    rank's.  A checkpoint under a mesh holds the whole trees, in the files
    a run without a mesh writes (rank 0 writes them; every rank gathers
    and waits for it)."""
    dev = resolve_device(device)
    if tcfg.checkpoint_every and not tcfg.checkpoint_dir:
        raise ValueError("checkpoint_every needs a checkpoint_dir")
    if params is None:
        gen = torch.Generator(device=dev).manual_seed(tcfg.seed)
        params = init_params(cfg, gen, dev,
                             dtype=getattr(torch, cfg.param_dtype))
    step_fns = {}

    def step_fn_for(name: str):
        if name not in step_fns:
            step_fns[name] = make_train_step(cfg, tcfg, dev, backend=name,
                                             mesh=mesh)
        return step_fns[name]

    def resolve_backend() -> str:
        return GB.resolve(None, config=_config_backend(cfg, tcfg)).name

    specs = None
    if mesh is not None:
        specs = step_fn_for(resolve_backend()).param_specs
        params = SH.shard_params(params, mesh, specs)
    opt_state = init_adamw(params)
    if batch_iterator is None:
        batch_iterator = make_batch_iterator(
            cfg.vocab_size, tcfg.seq_len, tcfg.batch_size, tcfg.seed)
    history = []
    t0 = time.perf_counter()
    for step in range(tcfg.total_steps):
        batch = next(batch_iterator)
        backend = resolve_backend()
        step_fn = step_fn_for(backend)
        ts = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        m = {k: float(v) for k, v in metrics.items()}
        m["step_s"] = time.perf_counter() - ts
        m["gmm_backend"] = backend
        m["remat_plan"] = step_fn.resolved_plan.spec
        m["peak_sim_bytes"] = step_fn.peak_sim_bytes
        m["moe_parallel"] = step_fn.moe_parallel
        if step_hook is not None:
            step_hook(step, m)
        if step % tcfg.log_every == 0 or step == tcfg.total_steps - 1:
            m["step"] = step
            m["wall_s"] = time.perf_counter() - t0
            history.append(m)
            log(f"step {step:5d} loss {m['loss']:.4f} ce {m['ce']:.4f} "
                f"gnorm {m['grad_norm']:.3f} lr {m['lr']:.2e} "
                f"({m['wall_s']:.1f}s)")
        if tcfg.checkpoint_every and step and \
                step % tcfg.checkpoint_every == 0:
            save_checkpoint(os.path.join(tcfg.checkpoint_dir,
                                         f"step_{step}"),
                            step, params, opt_state, mesh=mesh, specs=specs)
    return params, opt_state, history
