"""Activation-memory accounting — the harness behind the paper's >50%
activation-saving claim (§5.2), made regression-testable.

The port's counterpart of ``repro/bench/memory.py``, with its configs,
entry names and gates.  Three independent accountants per (model config x
checkpoint plan x grouped-GEMM backend):

  * **measured** — where the reference reads XLA's buffer assignment
    (``memory_analysis()``), the port reads the live-storage accounting of
    ``compat.trace_step`` over the gradient of the train loss: the
    arguments, the outputs and the most bytes the step's own allocations
    held at once (``arg_bytes`` / ``out_bytes`` / ``temp_bytes`` /
    ``peak_bytes``).  It traces fake tensors of the device, except where
    the backend cannot run on them (``timing.traces_real``: ``segment``
    and the kernels' plain versions read the routed counts to the host,
    ``ragged``'s fake kernel takes bf16 only): those trace real tensors of
    the same shapes, whose accounting equals the fake trace's byte for
    byte (``tests/test_torch_dryrun.py``).  On the card each report also
    records ``torch.cuda.max_memory_allocated`` over a real forward and
    backward, as its own informational entry (``allocated_bytes``);
  * **autograd residuals** — ``compat.saved_residual_nbytes`` (what the
    graph holds for its backward once the forward returned), parameters
    excluded;
  * **static estimate** — ``CheckpointPlan.estimate_saved_bytes``, from the
    plan's scoped tag decisions and the config's shapes alone.

Every entry stamps the resolved plan's canonical spec in its meta
(``remat_plan``).  ``memory_suite`` flattens the reports into
``repro_torch.bench.record`` entries and couples in the roofline model
(``roofline.analyze`` on the same trace).

The expert-parallel entries trace one rank of a ``launch.mesh.DryMesh(1,
2)`` as the dry run traces a rank: no ranks are spawned, and every
collective returns its result's shape (this rank's own blocks).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.bench.record import entry
from repro_torch.compat import saved_residual_nbytes, trace_step
from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.core import checkpoint as CK
from repro_torch.core import gmm_backend as GB
from repro_torch.core import memsim
from repro_torch.core.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.train.optimizer import tree_leaves

#: relative tolerance of the simulated-vs-measured peak parity gate (and of
#: the ``peak_sim/*`` entries' own baseline drift) — the deterministic-entry
#: tolerance the acceptance bar names.
SIM_PARITY_TOLERANCE_PCT = 20.0

#: policy order used by suites and by the ordering assertions in tests —
#: derived from the CheckpointPlan registry (tag plans by ascending save
#: set, then the specials), never hand-maintained in parallel again.
POLICY_ORDER = CK.plan_order()

#: the simulator's timeline the ``peak_sim/*`` entries follow: the port's
#: own (``core/memsim.py``; the reference's ``"xla"`` timeline describes
#: XLA's buffer assignment, not PyTorch's allocations: ROADMAP §C, C11)
SCHEDULE = "torch"

#: the expert-parallel entries' mesh: one rank of (data, model) = (1, 2)
EP_MESH = ((1, 2), ("data", "model"))


def bench_config():
    """The small MoE config every tracked bench number is measured on (the
    same harness takes any ``ModelConfig``)."""
    return get_config("qwen3_moe_30b_a3b").reduced().replace(
        name="tiny_moe", num_layers=2, d_model=64, num_heads=2,
        num_kv_heads=2, head_dim=32, num_experts=4, top_k=2, moe_d_ff=128,
        vocab_size=128, dtype="float32", scan_layers=True)


def bench_dense_config():
    """Dense SwiGLU companion config: its FFN carries the full A/B/Y_swi tag
    set, so it is where the strict ``none < paper_min < paper < full``
    residual ordering is measurable (the MoE expert FFN manages its own
    residuals inside its autograd Function)."""
    return get_config("yi_6b").reduced().replace(
        name="tiny_dense", num_layers=2, d_model=64, num_heads=2,
        num_kv_heads=2, head_dim=32, d_ff=128, vocab_size=128,
        dtype="float32", scan_layers=True)


def bench_ep_config():
    """MoE config for the expert-parallel residual entries.  ``E_loc = E /
    n_model`` must exceed ``top_k`` for the comparison to be meaningful: the
    dense-EP formulation materializes (L, E_loc, h) intermediates while the
    dispatch path's scale with L·k rows."""
    return bench_config().replace(
        name="tiny_moe_ep", num_experts=8, top_k=2, moe_d_ff=128,
        gmm_backend="segment")


def _dense_ep_sublayer(x, p, cfg, mesh):
    """The dense-EP formulation the Dispatch-driven path replaced:
    (L, E_loc, h) einsums against a dense (L, E) combine-weight matrix, on
    this rank's expert block, summed over 'model'.  The port's own plain
    body (the reference keeps its shard_map body beside its bench), so the
    dispatch-EP residual numbers are gated against the formulation they
    displaced."""
    from repro_torch.core import collectives as C
    from repro_torch.core import routing
    B, S, d = x.shape
    E = cfg.num_experts
    E_loc = E // mesh.shape["model"]
    idx = mesh.axis_index("model")
    group = mesh.group("model")
    xf = C.enter_replicated(x.reshape(B * S, d), group)
    g = routing.top_k_gating(xf, p["wg"].to(xf.dtype), cfg.top_k)
    cw = torch.zeros(xf.shape[0], E, dtype=g.topk_weights.dtype,
                     device=xf.device).scatter(1, g.topk_experts.long(),
                                               g.topk_weights)
    cw_loc = cw[:, idx * E_loc:(idx + 1) * E_loc]
    w1, w2, w3 = (p[k].to(xf.dtype) for k in ("w1", "w2", "w3"))
    a = torch.einsum("ld,edh->leh", xf, w1)
    y_act = torch.nn.functional.silu(a) * torch.einsum("ld,edh->leh", xf, w2)
    p_out = torch.einsum("leh,ehd->led", y_act, w3)
    y = torch.einsum("le,led->ld", cw_loc.to(p_out.dtype), p_out)
    return C.psum_partials(y, group).reshape(B, S, d)


def _traces_real(cfg, backend: str, device) -> bool:
    from repro_torch.bench.timing import traces_real
    return traces_real(backend, getattr(torch, cfg.dtype), device)


def _params(cfg, device, *, fake: bool, mesh=None, mode=None):
    """Float32 masters of ``cfg`` on ``device`` requiring gradients (this
    rank's expert blocks for ``mode`` under a ``mesh``): fake tensors
    (call under ``FakeTensorMode``) or ones drawn from seed 0."""
    from repro_torch import sharding as SH
    from repro_torch.compat import empty_tree
    from repro_torch.interop import init_params
    dt = getattr(torch, cfg.param_dtype)
    if fake:
        params = empty_tree(init_params(cfg, device="meta", dtype=dt),
                            device)
    else:
        gen = torch.Generator(device=device).manual_seed(0)
        params = init_params(cfg, gen, device, dtype=dt)
    if mesh is not None:
        params = SH.local_params(params, mesh, mode)
    for t in tree_leaves(params):
        t.requires_grad_(True)
    return params


def _tokens(cfg, batch: int, seq: int, device, *, fake: bool):
    if fake:
        return torch.empty(batch, seq, dtype=torch.int32, device=device)
    rng = np.random.default_rng(0)
    return torch.as_tensor(rng.integers(0, cfg.vocab_size, (batch, seq)),
                           dtype=torch.int32, device=device)


def _loss_fn(cfg, mesh=None):
    def loss(params, tokens):
        batch = {"tokens": tokens, "labels": tokens}
        return T.train_loss(params, batch, cfg, mesh=mesh)[0]
    return loss


def _grad_fn(cfg, mesh=None):
    loss = _loss_fn(cfg, mesh)

    def grad(params, tokens):
        return torch.autograd.grad(loss(params, tokens), tree_leaves(params))
    return grad


def _run(cfg, batch: int, seq: int, device, fn, *, backend: str,
         mesh=None, mode=None):
    """``fn(f, params, tokens)`` for the grad of the train loss on the
    step's arguments: fake ones unless the backend reads the routed counts
    to the host."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    fake = not _traces_real(cfg, backend, device)
    with GB.use_backend(backend):
        if not fake:
            return fn(_params(cfg, device, fake=False, mesh=mesh, mode=mode),
                      _tokens(cfg, batch, seq, device, fake=False))
        with FakeTensorMode():
            return fn(_params(cfg, device, fake=True, mesh=mesh, mode=mode),
                      _tokens(cfg, batch, seq, device, fake=True))


def _traced_step(cfg, batch: int, seq: int, device, *, backend: str,
                 mesh=None, mode=None):
    """``compat.StepTrace`` of the train loss's gradient."""
    grad = _grad_fn(cfg, mesh)
    return _run(cfg, batch, seq, device,
                lambda p, t: trace_step(grad, p, t)[1], backend=backend,
                mesh=mesh, mode=mode)


def _allocated_bytes(cfg, batch: int, seq: int, device, *,
                     backend: str) -> int:
    """``torch.cuda.max_memory_allocated`` over a real forward and backward
    of the train loss, above what was allocated before its parameters and
    tokens were (so that it counts what ``peak_bytes`` counts)."""
    torch.cuda.synchronize(device)
    before = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    params = _params(cfg, device, fake=False)
    tokens = _tokens(cfg, batch, seq, device, fake=False)
    with GB.use_backend(backend):
        grads = _grad_fn(cfg)(params, tokens)
    torch.cuda.synchronize(device)
    peak = torch.cuda.max_memory_allocated(device) - before
    del grads, params, tokens
    return int(peak)


def ep_saved_residual_entries(*, small: bool = False, device=None) -> list:
    """Dense-EP vs dispatch-EP activation residuals on one rank of an
    expert-sharded (1, 2) mesh, measured in the same run: the refactor's
    memory claim as tracked numbers.  The dispatch entry is the regression
    gate; the dense entry documents the baseline it must stay strictly
    below."""
    from repro_torch.launch.mesh import DryMesh
    from repro_torch.models.moe_block import moe_sublayer
    dev = resolve_device(device)
    cfg = bench_ep_config()
    mesh = DryMesh(*EP_MESH)
    batch, seq = (2, 32) if small else (4, 64)
    params = _params(cfg.replace(num_layers=1), dev, fake=False, mesh=mesh,
                     mode="ep")["layers"][0]["moe"]
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(batch, seq, cfg.d_model, generator=gen).to(dev)
    x.requires_grad_(True)

    # Both functions return y only, so the router-aux branch is dead code in
    # both traces and the residual accounting compares like with like.
    def dispatch_fn(x, p):
        return moe_sublayer(x, p, cfg.replace(moe_parallel="ep"),
                            mesh=mesh)[0]

    def dense_fn(x, p):
        return _dense_ep_sublayer(x, p, cfg, mesh)

    with GB.use_backend("segment"):
        dense_b = saved_residual_nbytes(dense_fn, x, params)
        disp_b = saved_residual_nbytes(dispatch_fn, x, params)
    meta = {"batch": batch, "seq": seq, "mesh": "1x2",
            "num_experts": cfg.num_experts, "top_k": cfg.top_k}
    prefix = f"memory/{cfg.name}"
    return [
        entry(f"{prefix}/ep_dense/residual_bytes", dense_b,
              kind="residual_bytes", unit="bytes", tolerance_pct=20.0, **meta),
        entry(f"{prefix}/ep_dispatch/residual_bytes", disp_b,
              kind="residual_bytes", unit="bytes", tolerance_pct=20.0, **meta),
    ]


def residual_bytes(cfg, policy, *, batch: int = 2, seq: int = 32,
                   device=None) -> int:
    """Activation bytes autograd holds for backward under ``policy`` (a plan
    name, spec, or object; arguments/parameters excluded), on real tensors
    drawn from seed 0."""
    dev = resolve_device(device)
    cfg = cfg.replace(remat_policy=CK.resolve_plan(policy).spec)
    backend = GB.resolve(None, config=cfg.gmm_backend).name
    with GB.use_backend(backend):
        return saved_residual_nbytes(
            _loss_fn(cfg), _params(cfg, dev, fake=False),
            _tokens(cfg, batch, seq, dev, fake=False))


def activation_memory_report(cfg, policy, *, backend: str | None = None,
                             batch: int = 2, seq: int = 32,
                             with_roofline: bool = False,
                             with_residuals: bool = True,
                             device=None) -> dict:
    """Trace fwd+bwd of the train loss under (plan, backend) and account
    its memory three ways.  ``policy`` is a plan name, spec, or
    ``CheckpointPlan``; the resolved canonical spec is stamped into the
    report (``remat_plan``/``plan_source``).  Returns a flat dict of numbers
    (plus the roofline analysis dict when requested; on the card also
    ``allocated_bytes``).  ``with_residuals=False`` skips the
    saved-residuals pass and the static estimate (they are
    backend-independent — callers sweeping the backend axis need them only
    once)."""
    dev = resolve_device(device)
    rb = GB.resolve(backend, config=cfg.gmm_backend)
    plan_r = CK.resolve_plan(policy)
    cfg = cfg.replace(remat_policy=plan_r.spec, gmm_backend=rb.name)
    tr = _traced_step(cfg, batch, seq, dev, backend=rb.name)
    report = {
        "config": cfg.name, "policy": str(policy), "backend": rb.name,
        "backend_source": rb.source,
        "remat_plan": plan_r.spec, "plan_source": plan_r.source,
        "batch": batch, "seq": seq,
        "arg_bytes": tr.arg_bytes, "out_bytes": tr.out_bytes,
        "temp_bytes": tr.temp_bytes, "alias_bytes": tr.alias_bytes,
        "peak_bytes": tr.peak_bytes,
        "traced_on": "real" if _traces_real(cfg, rb.name, dev) else "fake",
        "residual_bytes": (residual_bytes(cfg, plan_r, batch=batch, seq=seq,
                                          device=dev)
                           if with_residuals else None),
        "est_saved_bytes": (plan_r.plan.estimate_saved_bytes(
            cfg, batch * seq, batch=batch) if with_residuals else None),
    }
    if dev.type == "cuda":
        report["allocated_bytes"] = _allocated_bytes(cfg, batch, seq, dev,
                                                     backend=rb.name)
    if with_roofline:
        from repro_torch.roofline import analyze
        shape = InputShape("bench", seq, batch, "train")
        report["roofline"] = analyze(tr, cfg, shape, n_chips=1)
    return report


def train_step_memory_entries(cfg, *, batch: int = 2, seq: int = 32,
                              device=None) -> list:
    """Whole-train-step (loss + grads + AdamW) memory via the train loop's
    ``compiled_step_memory`` hook."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.train.loop import compiled_step_memory
    dev = resolve_device(device)
    backend = GB.resolve(None, config=cfg.gmm_backend).name
    tcfg = TrainConfig(batch_size=batch, seq_len=seq)
    mem = compiled_step_memory(cfg, tcfg, backend=backend, device=dev,
                               real=_traces_real(cfg, backend, dev))
    prefix = f"memory/{cfg.name}/train_step"
    # The step's resolved backend and checkpoint plan ride in the meta —
    # stamped from the resolutions the traced step actually used, not
    # re-read from the env/config.
    meta = {"batch": batch, "seq": seq, "gmm_backend": mem["gmm_backend"],
            "remat_plan": mem["remat_plan"]}
    return [
        entry(f"{prefix}/temp_bytes", mem["temp_bytes"],
              kind="temp_bytes", unit="bytes", tolerance_pct=100.0, **meta),
        entry(f"{prefix}/arg_bytes", mem["arg_bytes"],
              kind="arg_bytes", unit="bytes", tolerance_pct=20.0, **meta),
    ]


def memory_suite(*, small: bool = False, device=None) -> list:
    """All memory-axis entries: (config x policy x backend) reports, the
    roofline coupling, and the train-step axis.  The MoE config sweeps the
    grouped-GEMM backend axis; the dense config carries the full FFN tag set
    (and therefore the strict policy ordering)."""
    dev = resolve_device(device)
    auto = GB.resolve(None).name
    # Entry names embed the backend: the portable `segment` is always swept
    # (and is the dense config's only axis — it has no grouped GEMM); the
    # auto-resolved backend adds its own entries.
    plan = [(bench_config(), list(dict.fromkeys(["segment", auto]))),
            (bench_dense_config(), ["segment"])]
    batch, seq = (2, 32) if small else (4, 64)
    out = []
    for cfg, backends in plan:
        for policy in POLICY_ORDER:
            for i, backend in enumerate(backends):
                with_roofline = policy == "paper" and i == 0
                r = activation_memory_report(cfg, policy, backend=backend,
                                             batch=batch, seq=seq,
                                             with_roofline=with_roofline,
                                             with_residuals=(i == 0),
                                             device=dev)
                prefix = f"memory/{cfg.name}/{policy}/{backend}"
                meta = {"batch": batch, "seq": seq,
                        "remat_plan": r["remat_plan"],
                        "traced_on": r["traced_on"]}
                out.append(entry(f"{prefix}/temp_bytes", r["temp_bytes"],
                                 kind="temp_bytes", unit="bytes",
                                 tolerance_pct=100.0, **meta))
                out.append(entry(f"{prefix}/peak_bytes", r["peak_bytes"],
                                 kind="peak_bytes", unit="bytes",
                                 tolerance_pct=100.0, **meta))
                if "allocated_bytes" in r:
                    out.append(entry(f"{prefix}/allocated_bytes",
                                     r["allocated_bytes"],
                                     kind="allocated_bytes", unit="bytes",
                                     tolerance_pct=None, **meta))
                if i == 0:  # backend-independent accountants: record once
                    sim = memsim.simulate_peak(cfg, batch * seq, batch=batch,
                                               plan=policy, mode="single",
                                               base="grad", schedule=SCHEDULE)
                    out.append(entry(
                        f"peak_sim/{cfg.name}/{policy}/single", sim,
                        kind="peak_sim_bytes", unit="bytes",
                        tolerance_pct=SIM_PARITY_TOLERANCE_PCT, **meta))
                    out.append(entry(
                        f"memory/{cfg.name}/{policy}/residual_bytes",
                        r["residual_bytes"], kind="residual_bytes",
                        unit="bytes", tolerance_pct=20.0, **meta))
                    if r["est_saved_bytes"] is not None:
                        out.append(entry(
                            f"memory/{cfg.name}/{policy}/est_saved_bytes",
                            r["est_saved_bytes"], kind="est_saved_bytes",
                            unit="bytes", tolerance_pct=20.0, **meta))
                if with_roofline:
                    from repro_torch.roofline import bench_entries
                    out += bench_entries(r["roofline"],
                                         f"memory/{cfg.name}/roofline")
    out += train_step_memory_entries(bench_config(), batch=batch, seq=seq,
                                     device=dev)
    out += ep_saved_residual_entries(small=small, device=dev)
    out += ep_peak_entries(small=small, device=dev)
    return out


def ep_peak_entries(*, small: bool = False, device=None) -> list:
    """Measured peaks AND simulated peaks of fwd+bwd under the
    expert-sharded modes (``ep`` and ``ep_a2a``, one rank of a (1, 2)
    mesh), one pair per registry plan — the distributed half of the
    simulator-parity matrix (the single-device half lives in
    :func:`memory_suite`'s ``peak_sim/*/single`` entries).  Pairs are
    emitted atomically so :func:`sim_parity_failures` never sees an
    unmatched sim entry."""
    from repro_torch.launch.mesh import DryMesh
    dev = resolve_device(device)
    mesh = DryMesh(*EP_MESH)
    n_model = mesh.shape["model"]
    batch, seq = (2, 32) if small else (4, 64)
    out = []
    for mode in ("ep", "ep_a2a"):
        cfg = bench_config().replace(moe_parallel=mode,
                                     gmm_backend="segment")
        for policy in POLICY_ORDER:
            c = cfg.replace(remat_policy=CK.resolve_plan(policy).spec)
            tr = _traced_step(c, batch, seq, dev, backend="segment",
                              mesh=mesh, mode=mode)
            sim = memsim.simulate_peak(c, batch * seq, batch=batch,
                                       plan=policy, mode=mode,
                                       n_model=n_model, base="grad",
                                       schedule=SCHEDULE)
            meta = {"batch": batch, "seq": seq, "mesh": "1x2",
                    "remat_plan": CK.resolve_plan(policy).spec}
            out.append(entry(f"memory/{cfg.name}/{policy}/{mode}/peak_bytes",
                             tr.peak_bytes, kind="peak_bytes", unit="bytes",
                             tolerance_pct=100.0, **meta))
            out.append(entry(f"peak_sim/{cfg.name}/{policy}/{mode}", sim,
                             kind="peak_sim_bytes", unit="bytes",
                             tolerance_pct=SIM_PARITY_TOLERANCE_PCT, **meta))
    return out


def sim_parity_failures(entries: list) -> list:
    """The simulated-vs-measured peak gate: every ``peak_sim/<cfg>/<plan>/
    <mode>`` entry must agree with its measured counterpart — the
    ``memory/<cfg>/<plan>/segment/peak_bytes`` entry for ``single`` (the
    simulator models the portable segment backend's buffers; other backends'
    peaks are tracked but not parity-gated) or ``memory/<cfg>/<plan>/<mode>/
    peak_bytes`` for the sharded modes — within the sim entry's tolerance.
    Returns human-readable failure lines (empty == parity holds)."""
    by_name = {e["name"]: e for e in entries}
    fails = []
    for e in entries:
        if not e["name"].startswith("peak_sim/"):
            continue
        _, cfg_name, plan, sim_mode = e["name"].split("/")
        backend = "segment" if sim_mode == "single" else sim_mode
        want = f"memory/{cfg_name}/{plan}/{backend}/peak_bytes"
        measured = by_name.get(want)
        if measured is None:
            fails.append(f"PARITY {e['name']}: measured counterpart "
                         f"{want} missing from this run")
            continue
        tol = e["tolerance_pct"] or SIM_PARITY_TOLERANCE_PCT
        err = (e["value"] - measured["value"]) / max(measured["value"], 1.0)
        if abs(err) * 100.0 > tol:
            fails.append(
                f"PARITY {e['name']}: sim {int(e['value']):,} vs measured "
                f"{int(measured['value']):,} ({err * 100.0:+.1f}% "
                f"> +/-{tol:.0f}%)")
    return fails
