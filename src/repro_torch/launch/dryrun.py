"""Dry run: trace one rank of the production mesh on fake tensors for every
(architecture x input shape) and report its memory, cost and roofline
terms, without a card for each rank.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mixtral_8x7b \
        --shape train_4k [--multi-pod] [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --device cpu \
        --no-probe --out build/dryrun.jsonl

The counterpart of ``repro/launch/dryrun.py``, which lowers and compiles
each pair for 256 (512) fake XLA devices and reads XLA's memory and cost
analysis.  The port runs one process per rank, so it traces one rank
(``launch.mesh.DryMesh``, rank 0 of ``make_production_mesh``) under
``torch._subclasses.FakeTensorMode``: the rank's blocks of the
parameters, AdamW moments, batch and cache are fake tensors, every
collective returns a tensor of its result's shape
(``core/collectives.ShapeGroup``), and no array is allocated on a device
and no kernel is launched.  ``compat.trace_step`` follows the live bytes
of every storage the step allocates and counts its operations, bytes and
collectives; ``roofline.analyze`` turns that into the reference's record
(``trace_s`` in place of ``lower_s`` / ``compile_s``).

What each kind traces (``build_traceable``): train, ``make_train_step``
with ``_num_microbatches`` microbatches on the rank's FSDP blocks and
batch rows; prefill, ``forward(last_only=True)`` without gradients in
``_prefill_chunks`` chunks; decode, ``decode_step`` with bf16 parameters
over ``init_cache`` blocked by ``sharding.cache_specs`` (each layer's
blocks gathered whole but for the batch rows before it runs, its new
value written back into them), at the last position of the cache.

``--device cuda`` (the default, as every entry point of the port) traces
fake CUDA tensors through the real kernel wrappers, which check their
inputs, allocate their outputs and workspaces and record their calls
(``kernels._lib.dry_run``); MoE archs trace the config's own
``moe_impl``, with ``use_pallas`` on as the launchers set it, and the
trace covers every layer (``"cost_probe": "traced"``).  This needs
PyTorch built with CUDA: on a CPU-only build the backward of a fake CUDA
step aborts the process, so ``--device cuda`` raises there and names
``--device cpu``.

``--device cpu`` follows the reference: MoE archs trace ``moe_impl=
"dense"`` unless ``--override`` names one (the plain grouped GEMMs read
the routed counts to the host, which a fake tensor cannot give), and the
cost terms come from two ``proxy_gmm`` probes of 1 and 2 pattern groups
extrapolated to the full depth (``full = M (B + (G-1)(C-B))``, clamped
at 0), as the reference prices the TPU's grouped GEMM.

The checkpoint-plan fields (``remat_fit``, ``hbm_budget``,
``peak_sim_bytes``, ``sim_phases``) and the ``moe_parallel`` decision
table come from ``CheckpointPlan.fit``, ``memsim.simulate`` and
``resolve_moe_parallel_ex`` at ``hw``'s constants (``H100_SXM``), as the
reference's do at the TPU's.  A pair that fails writes a ``FAIL(...)``
record and makes the exit code 1; ``--all`` goes on with the next pair.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys

import torch

from repro_torch import sharding as SH
from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, get_config
from repro_torch.configs.base import TrainConfig
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import H100_SXM, make_production_mesh


def _n_dp(mesh) -> int:
    n = 1
    for a in ("pod", "data"):
        if a in mesh.axis_names:
            n *= mesh.shape[a]
    return n


def _num_microbatches(shape, mesh, cfg=None) -> int:
    """Gradient accumulation count: the smallest power-of-two M (up to one
    sequence per device) that keeps the layer-scan residual carries under
    ~3.5 GiB per device (the reference's rule)."""
    m_cap = max(shape.global_batch // _n_dp(mesh), 1)
    if cfg is None:
        return min(8, m_cap)
    budget = 3.5 * 2 ** 30
    M = 1
    while M < m_cap:
        tokens_per_dev = shape.global_batch * shape.seq_len / (_n_dp(mesh)
                                                               * M)
        carry = cfg.num_layers * tokens_per_dev * cfg.d_model * 2
        if carry <= budget and M >= min(8, m_cap):
            break
        M *= 2
    return min(M, m_cap)


def _prefill_chunks(cfg, shape, mesh) -> int:
    """Chunked prefill for MoE archs: one request row a device a chunk
    (the reference's rule)."""
    if not cfg.is_moe:
        return 1
    return max(1, shape.global_batch // _n_dp(mesh))


def _mesh_label(mesh) -> str:
    return "x".join(str(mesh.shape[a]) for a in mesh.axis_names)


def _split(batch: dict, n: int) -> list[dict]:
    rows = next(iter(batch.values())).shape[0]
    if rows % n:
        raise ValueError(f"{rows} batch rows do not split into {n} chunks")
    size = rows // n
    return [{k: v[i * size:(i + 1) * size] for k, v in batch.items()}
            for i in range(n)]


def _moe_mode(cfg, mesh, n_tokens: int) -> str:
    """The mode the MoE body resolves at its slab, which the expert
    leaves are laid out for ("auto" for a dense model)."""
    if not cfg.is_moe:
        return "auto"
    from repro_torch.models.moe_block import resolve_moe_parallel
    return resolve_moe_parallel(cfg, mesh, n_tokens)


def _rows(batch: dict) -> int:
    return next(iter(batch.values())).shape[0]


def build_traceable(arch: str, shape_name: str, mesh, cfg_overrides=None,
                    shape=None, microbatches=None, device="cuda"):
    """Returns ``((fn, make_args), None, cfg)``, or ``(None, skip reason,
    cfg)`` for a pair that does not run.  ``make_args()``, called under
    ``FakeTensorMode``, gives ``(args, kwargs)`` for ``fn``: this rank's
    fake blocks.  The counterpart of the reference's ``build_lowerable``:
    on the CPU, MoE archs trace ``moe_impl="dense"`` unless the overrides
    name one; on the card, the config's own with ``use_pallas`` on."""
    from repro_torch.compat import empty_tree
    from repro_torch.models import transformer as T
    from repro_torch.train.loop import traceable_step
    dev = torch.device(device)
    overrides = dict(cfg_overrides or {})
    cfg = get_config(arch)
    if dev.type == "cpu" and cfg.is_moe and "moe_impl" not in overrides:
        cfg = cfg.replace(moe_impl="dense")
    if dev.type == "cuda" and "use_pallas" not in overrides:
        cfg = cfg.replace(use_pallas=True)
    if overrides:
        cfg = cfg.replace(**overrides)
    shape = shape or INPUT_SHAPES[shape_name]
    skip = S.applicable(cfg, shape)
    if skip:
        return None, skip, cfg
    dt = getattr(torch, cfg.dtype)

    if shape.kind == "train":
        M = microbatches if microbatches is not None \
            else _num_microbatches(shape, mesh, cfg)
        tcfg = TrainConfig(num_microbatches=M,
                           batch_size=shape.global_batch,
                           seq_len=shape.seq_len)
        return traceable_step(cfg, tcfg, dev, mesh=mesh), None, cfg

    if shape.kind == "prefill":
        bshapes = S.batch_shapes(cfg, shape)
        local = SH.local_batch(bshapes, SH.batch_specs(bshapes, mesh), mesh)
        Mp = _prefill_chunks(cfg, shape, mesh) if microbatches is None \
            else microbatches
        dp = SH.batch_axes(mesh, shape.global_batch // Mp)
        mode = _moe_mode(cfg, mesh, _rows(local) // Mp * shape.seq_len)
        whole = S.params_shapes(cfg)
        pspecs = SH.param_specs(whole, mesh, fsdp=True, moe_parallel=mode)
        blocks = SH.shard_params(whole, mesh, pspecs)
        fsdp = SH.FSDP(mesh, pspecs, dp, dt)

        def prefill(params, batch):
            # only the last position's logits (the first sampled token);
            # MoE archs in chunks of rows, to bound the dispatch buffers
            with torch.no_grad():
                out = [T.forward(params, mb, cfg, mesh=mesh, dp_axes=dp,
                                 fsdp=fsdp, last_only=True)
                       for mb in _split(batch, Mp)]
            return (torch.cat([lg[:, -1, :] for lg, _ in out]),
                    torch.stack([aux for _, aux in out]).mean())

        def make_args():
            return (empty_tree(blocks, dev), empty_tree(local, dev)), {}
        return (prefill, make_args), None, cfg

    # decode: serving's bf16 weights (float32 masters are training's)
    cfg = cfg.replace(param_dtype="bfloat16")
    ds = S.decode_shapes(cfg, shape)
    tok = {"tokens": ds["tokens"]}
    tok = SH.local_batch(tok, SH.batch_specs(tok, mesh), mesh)
    mode = _moe_mode(cfg, mesh, _rows(tok))
    whole = S.params_shapes(cfg)
    pspecs = SH.param_specs(whole, mesh,
                            fsdp=not cfg.serve_replicate_weights,
                            moe_parallel=mode)
    blocks = SH.shard_params(whole, mesh, pspecs)
    cspecs = SH.cache_specs(cfg, ds["cache"], mesh)
    cache = SH.shard_cache(ds["cache"], cspecs, mesh)
    fsdp = SH.FSDP(mesh, pspecs, (), dt)
    pos = shape.seq_len - 1

    def decode(params, cache, tokens):
        with torch.no_grad():
            return T.decode_step(params, cache, {"tokens": tokens}, pos,
                                 cfg, mesh=mesh, fsdp=fsdp,
                                 cache_specs=cspecs)

    def make_args():
        return ((empty_tree(blocks, dev), empty_tree(cache, dev),
                 empty_tree(tok["tokens"], dev)), {})
    return (decode, make_args), None, cfg


def _trace_once(arch, shape_name, mesh, cfg_overrides, shape=None,
                microbatches=None, device="cuda"):
    """``(compat.StepTrace, None, cfg)`` of one pair, or ``(None, skip,
    cfg)``."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.compat import trace_step
    built, skip, cfg = build_traceable(arch, shape_name, mesh,
                                       cfg_overrides, shape=shape,
                                       microbatches=microbatches,
                                       device=device)
    if skip:
        return None, skip, cfg
    fn, make_args = built
    with FakeTensorMode():
        args, kwargs = make_args()
        _, trace = trace_step(fn, *args, **kwargs)
    return trace, None, cfg


def _plan_fields(cfg0, ishape, mesh, *, microbatches=None,
                 remat_policy=None, hbm_budget=None, hw=H100_SXM):
    """The record's checkpoint-plan and ``moe_parallel`` fields for the
    per-device slab (the reference's ``run_one`` before it compiles), and
    the resolved plan."""
    from repro_torch.core import checkpoint as CK
    from repro_torch.core import memsim
    prefer = CK.get_plan(remat_policy) if remat_policy else None
    n_dp = _n_dp(mesh)
    b_dev = max(ishape.global_batch // max(n_dp, 1), 1)
    if ishape.kind == "train":
        M = microbatches if microbatches is not None \
            else _num_microbatches(ishape, mesh, cfg0)
        b_dev = max(b_dev // M, 1)
    n_model = max(mesh.shape.get("model", 1), 1)
    n_node = max(mesh.shape.get("node", 1), 1)
    rec, moe_mode = {}, None
    if cfg0.is_moe:
        from repro_torch.models.moe_block import resolve_moe_parallel_ex
        decision = resolve_moe_parallel_ex(cfg0, mesh,
                                           b_dev * ishape.seq_len, hw=hw)
        moe_mode = decision.mode
        rec["moe_parallel"] = decision.mode
        rec["moe_parallel_source"] = decision.source
        rec["moe_parallel_tokens"] = decision.n_tokens
        rec["moe_parallel_decision"] = decision.table_rows()
    if hbm_budget is not None:
        fit = CK.CheckpointPlan.fit(
            cfg0, b_dev * ishape.seq_len, hbm_budget, batch=b_dev,
            prefer=prefer, mode=moe_mode, n_model=n_model, n_node=n_node)
        plan_r = fit.resolved
        rec["remat_fit"] = [dict(dataclasses.asdict(r), source="fit")
                            for r in fit.table]
        rec["hbm_budget"] = fit.budget_bytes
        timeline = fit.timeline
    else:
        plan_r = CK.resolve_plan(remat_policy, config=cfg0.remat_policy)
        timeline = memsim.simulate(
            cfg0, b_dev * ishape.seq_len, batch=b_dev, plan=plan_r.plan,
            mode=moe_mode, n_model=n_model, n_node=n_node, base="train")
        src = "explicit" if plan_r.source == "arg" else plan_r.source
        rec["remat_fit"] = [dict(
            spec=plan_r.spec, est_saved_bytes=plan_r.plan.estimate_saved_bytes(
                cfg0, b_dev * ishape.seq_len, batch=b_dev),
            fits=None, chosen=True, sim_peak_bytes=timeline.peak_bytes,
            peak_phase=timeline.peak_phase, source=src)]
    rec["remat_plan"] = plan_r.spec
    rec["remat_plan_source"] = plan_r.source
    rec["peak_sim_bytes"] = timeline.peak_bytes
    rec["peak_sim_phase"] = timeline.peak_phase
    rec["sim_phases"] = [
        {"phase": p.name, "held_bytes": p.held_bytes,
         "transient_bytes": p.transient_bytes,
         "collective_bytes": p.collective_bytes, "live_bytes": p.live_bytes}
        for p in sorted(timeline.phases, key=lambda p: -p.live_bytes)[:4]]
    return rec, plan_r


def run_one(arch: str, shape_name: str, *, multi_pod: bool = False,
            cfg_overrides=None, verbose: bool = True,
            cost_probe: bool = True, microbatches: int | None = None,
            remat_policy: str | None = None,
            hbm_budget: int | None = None, device="cuda", hw=H100_SXM,
            mesh=None, shape=None) -> dict:
    """Dry-run one (arch x shape x mesh) on rank 0 of the production mesh
    (or of ``mesh``, a ``DryMesh``; ``shape`` an ``InputShape`` in place
    of ``INPUT_SHAPES[shape_name]``) and return its record."""
    from repro_torch.core.gmm_backend import resolve
    from repro_torch.roofline import analyze
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the dry run's card path traces fake CUDA tensors, which needs "
            "PyTorch built with CUDA and a card; run with --device cpu")
    mesh = mesh or make_production_mesh(multi_pod=multi_pod, dry=True)
    n_chips = mesh.axis_size(mesh.axis_names)
    ishape = shape or INPUT_SHAPES[shape_name]
    rec = {"arch": arch, "shape": shape_name, "mesh": _mesh_label(mesh)}
    cfg_overrides = dict(cfg_overrides or {})
    cfg0 = get_config(arch).replace(**cfg_overrides)
    fields, plan_r = _plan_fields(cfg0, ishape, mesh,
                                  microbatches=microbatches,
                                  remat_policy=remat_policy,
                                  hbm_budget=hbm_budget, hw=hw)
    rec.update(fields)
    cfg_overrides["remat_policy"] = plan_r.spec
    trace, skip, cfg = _trace_once(arch, shape_name, mesh, cfg_overrides,
                                   shape=shape, microbatches=microbatches,
                                   device=device)
    rec["gmm_backend"] = resolve(None, config=cfg.gmm_backend).name
    if skip:
        rec["status"] = f"SKIP({skip})"
        return rec
    full = analyze(trace, cfg, ishape, n_chips=n_chips, hw=hw)
    rec.update(status="OK", trace_s=round(trace.seconds, 1), **full)
    rec["kernels"] = trace.kernels

    if torch.device(device).type == "cuda":
        rec["cost_probe"] = "traced"
    elif cost_probe and cfg.num_groups > 1:
        period = cfg.pattern_period
        # the probes trace ONE microbatch (or prefill chunk) and scale the
        # result by M
        M = 1
        if ishape.kind == "train":
            M = microbatches if microbatches is not None \
                else _num_microbatches(ishape, mesh, cfg)
        elif ishape.kind == "prefill":
            M = microbatches if microbatches is not None \
                else _prefill_chunks(cfg, ishape, mesh)
        pshape = ishape
        if M > 1:
            pshape = dataclasses.replace(
                ishape, global_batch=ishape.global_batch // M)
        probes = []
        for g in (1, 2):
            ov = dict(cfg_overrides)
            ov.update(num_layers=g * period, scan_layers=False)
            if cfg.is_moe:
                ov.setdefault("moe_impl", "proxy_gmm")
            ptrace, pskip, pcfg = _trace_once(
                arch, shape_name, mesh, ov, shape=pshape, microbatches=1,
                device=device)
            assert pskip is None
            probes.append(analyze(ptrace, pcfg, ishape, n_chips=n_chips,
                                  hw=hw))
        b, c = probes
        G = cfg.num_groups

        def extrap(key):
            # clamped: a 2-group probe may come out cheaper than the
            # 1-group one, which would extrapolate below zero
            return max(0.0, M * (b[key] + (G - 1) * (c[key] - b[key])))

        rec["flops_per_dev"] = extrap("flops_per_dev")
        rec["hlo_bytes_per_dev"] = extrap("hlo_bytes_per_dev")
        rec["collective_bytes"] = extrap("collective_bytes")
        rec["collective_counts"] = {
            k: max(0, b["collective_counts"][k] +
                   (G - 1) * (c["collective_counts"][k]
                              - b["collective_counts"][k]))
            for k in b["collective_counts"]}
        rec["t_compute_s"] = rec["flops_per_dev"] / hw.peak_flops_bf16
        rec["t_memory_s"] = rec["hlo_bytes_per_dev"] / hw.hbm_bw
        rec["t_collective_s"] = rec["collective_bytes"] / hw.intra_node_bw
        rec["dominant"] = max(
            (("compute", rec["t_compute_s"]), ("memory", rec["t_memory_s"]),
             ("collective", rec["t_collective_s"])), key=lambda kv: kv[1])[0]
        rec["useful_flops_ratio"] = rec["model_flops_global"] / max(
            rec["flops_per_dev"] * n_chips, 1.0)
        rec["cost_probe"] = "extrapolated(1,2 groups unrolled)"

    if verbose and rec.get("moe_parallel_decision"):
        print(f"  moe_parallel={rec['moe_parallel']} "
              f"(source={rec['moe_parallel_source']}, "
              f"ranked at {rec['moe_parallel_tokens']} tokens/dev):")
        for r in rec["moe_parallel_decision"]:
            mark = "*" if r["chosen"] else " "
            why = "" if r["feasible"] else f"  [{r['why']}]"
            print(f"  {mark} {r['mode']:<12}"
                  f" t={r['t_total_s'] * 1e6:9.1f}us"
                  f" (comp {r['t_compute_s'] * 1e6:.1f}"
                  f" mem {r['t_memory_s'] * 1e6:.1f}"
                  f" coll {r['t_collective_s'] * 1e6:.1f})"
                  f" live={r['live_bytes'] / 2**20:8.1f}MiB"
                  f" a2a={r['a2a_bytes'] / 2**20:.2f}MiB"
                  f" psum={r['psum_bytes'] / 2**20:.2f}MiB{why}")
        by_kind = rec.get("collective_bytes_by_kind")
        if by_kind:
            kinds = " ".join(f"{k}={v / 2**20:.1f}MiB"
                             for k, v in sorted(by_kind.items()))
            print(f"    traced (this rank, whole step): {kinds}")
    if verbose:
        print(f"[{arch} x {shape_name} x {rec['mesh']}] "
              f"plan={rec['remat_plan']} "
              f"args={rec['arg_bytes']/2**30:.2f}GiB "
              f"temp={rec['temp_bytes']/2**30:.2f}GiB "
              f"peak={rec['peak_bytes']/2**30:.2f}GiB/dev "
              f"fits={rec['fits_hbm']} | flops/dev={rec['flops_per_dev']:.3e} "
              f"coll={rec['collective_bytes']/2**20:.1f}MiB "
              f"dominant={rec['dominant']}")
        print(f"  trace: arg {rec['arg_bytes']} out {rec['out_bytes']} "
              f"temp {rec['temp_bytes']} alias {rec['alias_bytes']} bytes, "
              f"{rec['trace_s']} s")
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(INPUT_SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None, help="append JSONL records here")
    ap.add_argument("--override", default=None,
                    help="JSON dict of ModelConfig overrides")
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--no-probe", action="store_true",
                    help="skip the cost-extrapolation probes (--device cpu)")
    ap.add_argument("--tag", default=None,
                    help="label recorded with each JSONL row")
    ap.add_argument("--gmm-backend", default=None,
                    help="grouped-GEMM backend for MoE traces "
                         "(ragged | segment | pallas | pallas_fused)")
    ap.add_argument("--moe-parallel", default=None,
                    choices=["auto", "ep", "ep_a2a", "ep_a2a_hier", "tp"],
                    help="MoE distribution mode (config field "
                         "moe_parallel)")
    ap.add_argument("--remat-policy", default=None,
                    help="activation-checkpoint plan: registry name or spec")
    ap.add_argument("--hbm-budget", default=None,
                    help="per-device train-step peak budget (bytes; "
                         "KiB/MiB/GiB suffixes ok): CheckpointPlan.fit "
                         "picks the plan over the simulated peaks")
    ap.add_argument("--jobs", type=int, default=1,
                    help="trace this many pairs at once, each in a process "
                         "of its own (a trace takes one host core)")
    ap.add_argument("--device", default="cuda",
                    help="cuda: fake CUDA tensors through the kernel "
                         "wrappers (needs PyTorch with CUDA); cpu: the "
                         "reference's dense lowering and proxy_gmm probes")
    args = ap.parse_args(argv)
    from repro_torch.core.checkpoint import get_plan, parse_size
    if args.remat_policy:
        get_plan(args.remat_policy)      # validate before any trace
    hbm_budget = parse_size(args.hbm_budget) if args.hbm_budget else None
    overrides = json.loads(args.override) if args.override else None
    if args.moe_parallel:
        overrides = dict(overrides or {}, moe_parallel=args.moe_parallel)
    if args.all:
        pairs = [(a, s) for a in ARCH_IDS for s in INPUT_SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape (or --all)")
        pairs = [(args.arch, args.shape)]

    kw = dict(multi_pod=args.multi_pod, cfg_overrides=overrides,
              microbatches=args.microbatches, cost_probe=not args.no_probe,
              remat_policy=args.remat_policy, hbm_budget=hbm_budget,
              device=args.device, verbose=args.jobs <= 1)
    ok = True

    def report(rec):
        nonlocal ok
        if args.tag:
            rec["tag"] = args.tag
        if rec["status"].startswith("FAIL"):
            ok = False
            print(f"[{rec['arch']} x {rec['shape']}] FAILED: "
                  f"{rec['status']}", file=sys.stderr)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")
        else:
            print(json.dumps(rec), flush=True)

    if args.jobs <= 1:
        for arch, shape in pairs:
            report(_run_pair(arch, shape, args.gmm_backend, kw))
        return 0 if ok else 1
    import concurrent.futures as cf
    import multiprocessing as mp

    from repro_torch.launch import dryrun as this  # picklable by name
    with cf.ProcessPoolExecutor(args.jobs,
                                mp_context=mp.get_context("spawn")) as ex:
        futs = [ex.submit(this._run_pair, arch, shape, args.gmm_backend, kw)
                for arch, shape in pairs]
        for fut in cf.as_completed(futs):
            report(fut.result())
    return 0 if ok else 1


def _run_pair(arch: str, shape: str, gmm_backend, kw: dict) -> dict:
    """``run_one`` of one pair, or its ``FAIL(...)`` record: one pair's
    failure does not stop the others (the reference's reporting)."""
    from repro_torch.core.gmm_backend import use_backend
    scope = (use_backend(gmm_backend) if gmm_backend
             else contextlib.nullcontext())
    try:
        with scope:
            return run_one(arch, shape, **kw)
    except Exception as e:  # noqa: BLE001 -- report and go on
        return {"arch": arch, "shape": shape,
                "mesh": "2x16x16" if kw["multi_pod"] else "16x16",
                "status": f"FAIL({type(e).__name__}: {e})"}


if __name__ == "__main__":
    raise SystemExit(main())
