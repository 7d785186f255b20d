"""Kernel/backend timing axis of the bench harness (paper §5.2 analogues).

The port's counterpart of ``repro/bench/timing.py``: fused vs unfused
SwiGLU traffic, the hand-written fused-SwiGLU kernel's wall time, the
grouped-GEMM backend comparison, the fused MoE path against the unfused
kernel composition, the distribution modes next to the cost model's
predictions, and one train-step timing probe through ``train.loop``'s
``step_hook``.  On the card the ``pallas`` / ``pallas_fused`` backends and
the fused-SwiGLU entry run the hand-written Hopper kernels; on the CPU the
same wrappers run their plain versions.

Timing protocol: ``median_time_us`` — ``warmup`` untimed calls, then the
median of ``iters`` individually fenced calls (``torch.cuda.synchronize``
on the card).  Medians, not means: a single GC pause or a shared host's
hiccup must not move the recorded number.  Wall-clock entries are
informational (``tolerance_pct=None``), while traced flops/bytes are
deterministic and gated.

What the reference reads from XLA's cost analysis (``hlo_cost``) the port
reads from ``compat.trace_step`` (:func:`trace_cost`): aten's products and
attention by ``torch.utils.flop_counter``'s formulas plus the kernels'
recorded operations, and each op's inputs and outputs once (no fusion
assumed).  The numbers are the port's own, not the reference's.

Renamed entry: the reference's ``kernels/pallas_fused_swiglu_interpret/
time`` (the Pallas kernel in interpret mode) is
``kernels/fused_swiglu_fwd/time`` here, the hand-written kernel on the
card (its plain version on the CPU; ``meta.path`` says which).

Exception to "wall time is informational": the ``kernels/fused_path/*``
entries are pair-gated against each other in the SAME run by
:func:`fused_gate_failures` (wired into ``repro_torch.bench --check``) —
relative ordering on one machine is meaningful even when absolute numbers
are not; likewise the ``kernels/parallel/*`` family
(:func:`parallel_gate_failures`).
"""

from __future__ import annotations

import math
import os
import pickle
import shutil
import statistics
import tempfile
import time
from datetime import timedelta
from pathlib import Path

import torch

from repro_torch.bench.record import entry
from repro_torch.core.device import resolve_device


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def median_time_us(fn, *args, warmup: int = 2, iters: int = 5) -> float:
    """Median wall time of ``fn(*args)`` in microseconds, each call fenced
    with ``torch.cuda.synchronize`` on the card so asynchronous launches
    cannot hide work."""
    for _ in range(max(warmup, 1)):
        fn(*args)
        _sync()
    samples = []
    for _ in range(max(iters, 1)):
        _sync()
        t0 = time.perf_counter()
        fn(*args)
        _sync()
        samples.append((time.perf_counter() - t0) * 1e6)
    return statistics.median(samples)


def trace_cost(fn, *args) -> tuple[float, float]:
    """(flops, bytes accessed) of ``fn(*args)`` from ``compat.trace_step``
    (the counterpart of the reference's ``hlo_cost``).  Pass fake tensors
    (made under ``FakeTensorMode``) to trace without computing; real ones
    where the function reads the routed counts to the host."""
    from repro_torch.compat import trace_step
    _, tr = trace_step(fn, *args)
    return tr.flops, tr.bytes_accessed


def _leaves_grad(fn, n: int):
    """``fn``'s scalar result differentiated by its first ``n`` arguments
    (the counterpart of ``jax.grad(fn, argnums=range(n))``: an argument
    ``fn`` does not use gets zeros)."""
    def g(*args):
        return torch.autograd.grad(fn(*args), args[:n], allow_unused=True,
                                   materialize_grads=True)
    return g


def _fake(shapes, dtype, device):
    """Fake tensors of ``shapes`` (call under ``FakeTensorMode``), each
    requiring a gradient."""
    return [torch.empty(s, dtype=dtype, device=device).requires_grad_(True)
            for s in shapes]


def swiglu_traffic_entries(L=4096, d=1024, h=4096, dtype=torch.bfloat16, *,
                           device=None) -> list:
    """Traced traffic of fwd+bwd SwiGLU: naive autograd (saves every
    elementwise intermediate) vs the paper checkpoint plan (save A/B,
    recompute SiLU), on fake tensors of the device."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.core import checkpoint as CK
    dev = resolve_device(device)

    def naive(x, w1, w2):
        return (torch.nn.functional.silu(x @ w1) * (x @ w2)).float().sum()

    policy = CK.SavePolicy(tags=tuple(
        t for t in CK.get_plan("paper_min").saved
        if t in (CK.FFN_A, CK.FFN_B)))

    def paper_ckpt(x, w1, w2):
        def inner(x):
            with CK.tagged(CK.FFN_A):
                a = x @ w1
            with CK.tagged(CK.FFN_B):
                b = x @ w2
            return torch.nn.functional.silu(a) * b
        return CK.checkpoint(inner, x, policy=policy).float().sum()

    meta = {"L": L, "d": d, "h": h}
    out = []
    for name, f in (("naive", naive), ("paper_ckpt", paper_ckpt)):
        with FakeTensorMode():
            args = _fake(((L, d), (d, h), (d, h)), dtype, dev)
            fl, by = trace_cost(_leaves_grad(f, 3), *args)
        out.append(entry(f"kernels/swiglu_traffic/{name}/flops", fl,
                         kind="flops", unit="flop", tolerance_pct=20.0, **meta))
        out.append(entry(f"kernels/swiglu_traffic/{name}/bytes", by,
                         kind="bytes_accessed", unit="bytes",
                         tolerance_pct=100.0, **meta))
    return out


def _randn(gen, shape, device, scale=1.0, dtype=torch.float32):
    return (torch.randn(shape, generator=gen) * scale).to(device, dtype)


def pallas_kernel_entries(L=1024, d=256, h=512, iters=5, *,
                          device=None) -> list:
    """Wall time of the fused-SwiGLU forward (``kernels.fused_swiglu_fwd``):
    the hand-written kernel on the card, its plain version on the CPU."""
    from repro_torch.kernels.fused_swiglu import fused_swiglu_fwd
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(0)
    x = _randn(gen, (L, d), dev)
    w1 = _randn(gen, (d, h), dev, 0.05)
    w2 = _randn(gen, (d, h), dev, 0.05)
    us = median_time_us(fused_swiglu_fwd, x, w1, w2, warmup=1, iters=iters)
    return [entry("kernels/fused_swiglu_fwd/time", us, kind="time_us",
                  unit="us", L=L, d=d, h=h,
                  path="cuda" if dev.type == "cuda" else "plain")]


def traces_real(name: str, dtype: torch.dtype, device) -> bool:
    """True when backend ``name`` cannot be traced on fake tensors of
    ``dtype``, so its step is traced on real ones of the same shapes:
    ``segment`` and, on the CPU, the kernels' plain versions read the
    routed counts to the host, which a fake tensor cannot give; the fake
    kernel of ``torch._grouped_mm`` (``ragged``) takes bf16 only."""
    device = torch.device(device)
    return (name == "segment"
            or (device.type == "cpu" and name in ("pallas", "pallas_fused"))
            or (name == "ragged" and dtype != torch.bfloat16))


def gmm_backend_entries(S=2048, d=256, h=512, E=8, iters=5, *,
                        include_pallas=False, device=None) -> list:
    """Every available grouped-GEMM backend on one routed workload: median
    wall time of fwd + dw plus the forward's traced flops/bytes.

    ``pallas`` is the hand-written gather-GMM and ``gmm_dw`` kernels on the
    card and their plain versions on the CPU (opt-in there, as the
    reference's interpret mode is); ``ragged`` is ``torch._grouped_mm``.
    The flops and bytes are traced on fake tensors where the backend
    allows it (:func:`traces_real`)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.core import gmm_backend as GB
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(0)
    lhs = _randn(gen, (S, d), dev)
    rhs = _randn(gen, (E, d, h), dev, 0.05)
    dout = _randn(gen, (S, h), dev)
    base = S // E
    gs = torch.tensor([base] * (E - 1) + [S - base * (E - 1)],
                      dtype=torch.int32, device=dev)

    out = []
    meta = {"S": S, "d": d, "h": h, "E": E}
    for name in GB.available_backends():
        if name == "pallas_fused":
            continue          # the same grouped GEMMs as ``pallas``
        if name == "pallas" and not include_pallas:
            continue

        def fwd(lhs, rhs, gs, _name=name):
            return GB.gmm(lhs, rhs, gs, backend=_name)

        def dw(lhs, dout, gs, _name=name):
            return GB.gmm_dw(lhs, dout, gs, backend=_name)

        if traces_real(name, lhs.dtype, dev):
            fl, by = trace_cost(fwd, lhs, rhs, gs)
        else:
            with FakeTensorMode():
                fl, by = trace_cost(fwd, *(
                    torch.empty(t.shape, dtype=t.dtype, device=t.device)
                    for t in (lhs, rhs, gs)))
        us = median_time_us(lambda: (fwd(lhs, rhs, gs), dw(lhs, dout, gs)),
                            warmup=1, iters=iters)
        out.append(entry(f"kernels/gmm_backend/{name}/time", us,
                         kind="time_us", unit="us", **meta))
        out.append(entry(f"kernels/gmm_backend/{name}/flops", fl,
                         kind="flops", unit="flop", tolerance_pct=20.0, **meta))
        out.append(entry(f"kernels/gmm_backend/{name}/bytes", by,
                         kind="bytes_accessed", unit="bytes",
                         tolerance_pct=100.0, **meta))
    return out


def fused_path_entries(L=128, d=64, h=128, E=8, k=2, iters=3, *,
                       device=None) -> list:
    """The fused dispatch→GEMM→combine layer vs the unfused kernel
    composition it replaces, on one routed MoE shape: median fwd+grad
    wall time plus the saved-residual accounting — how many ``(L·k, h)`` /
    ``(L·k, d)`` slot buffers autograd holds, and their bytes
    (``compat.saved_residuals``).

    The time entries are informational against the *baseline* but
    load-bearing against *each other*: :func:`fused_gate_failures` pairs
    them in the same run — same machine, same process."""
    from repro_torch.compat import saved_residuals
    from repro_torch.core.moe_layer import moe_ffn_blaze
    from repro_torch.core.routing import top_k_gating
    from repro_torch.kernels.dispatch import build_dispatch
    from repro_torch.kernels.ops import moe_ffn_blaze_pallas

    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(0)
    x = _randn(gen, (L, d), dev)
    wg = _randn(gen, (d, E), dev, 0.1)
    w1 = _randn(gen, (E, d, h), dev, 0.05)
    w2 = _randn(gen, (E, d, h), dev, 0.05)
    w3 = _randn(gen, (E, h, d), dev, 0.05)
    g = top_k_gating(x, wg, k)
    disp = build_dispatch(g.topk_experts.contiguous(), E)
    gates = g.topk_weights.detach().contiguous()
    S = L * k
    args = [t.requires_grad_(True) for t in (x, w1, w2, w3, gates)]

    def layer(label):
        if label == "fused":
            def f(x, w1, w2, w3, gates):
                return moe_ffn_blaze(x, gates, disp, w1, w3, w2,
                                     backend="pallas_fused")
        else:
            def f(x, w1, w2, w3, gates):
                return moe_ffn_blaze_pallas(x, gates, disp, w1, w3, w2)
        return f

    def slot_buffers(label):
        n, nbytes = 0, 0
        for shape, _, nb, _ in saved_residuals(layer(label), *args):
            if tuple(shape) in ((S, h), (S, d)):
                n += 1
                nbytes += nb
        return n, nbytes

    def grad_fn(label):
        f = layer(label)

        def loss(x, w1, w2, w3, gates):
            return (f(x, w1, w2, w3, gates).float() ** 2).sum()

        return _leaves_grad(loss, 5)

    meta = {"L": L, "d": d, "h": h, "E": E, "k": k}
    out = []
    for label in ("fused", "unfused_pallas"):
        us = median_time_us(grad_fn(label), *args, warmup=1, iters=iters)
        n, nbytes = slot_buffers(label)
        gated = 0.0 if label == "fused" else None   # fused counts must be 0
        out.append(entry(f"kernels/fused_path/{label}/time", us,
                         kind="time_us", unit="us", **meta))
        out.append(entry(f"kernels/fused_path/{label}/slot_buffers", n,
                         kind="count", unit="buffers", tolerance_pct=gated,
                         **meta))
        out.append(entry(f"kernels/fused_path/{label}/slot_residual_bytes",
                         nbytes, kind="bytes", unit="bytes",
                         tolerance_pct=gated, **meta))
    return out


def fused_gate_failures(entries: list) -> list:
    """Same-run pairing gates for the fused MoE path (the analogue of the
    memory suite's ``sim_parity_failures``): (1) the fused layer's autograd
    must hold ZERO ``(L·k, ·)`` slot buffers — the whole point of the
    fusion — and (2) its fwd+grad wall time must not exceed the unfused
    kernel composition measured in the *same* run.  Returns human-readable
    failure lines (empty == both gates hold)."""
    by_name = {e["name"]: e for e in entries}
    pre = "kernels/fused_path"
    fused_n = by_name.get(f"{pre}/fused/slot_buffers")
    fused_t = by_name.get(f"{pre}/fused/time")
    ref_t = by_name.get(f"{pre}/unfused_pallas/time")
    if fused_n is None and fused_t is None and ref_t is None:
        # No fused_path family at all (synthetic/legacy record): nothing to
        # pair.  Fresh runs always emit the family via ``kernels_suite``.
        return []
    if fused_n is None or fused_t is None or ref_t is None:
        return [f"FUSED {pre}/* family incomplete in this run "
                "(regenerate the record with the current suite)"]
    fails = []
    if fused_n["value"] != 0:
        fails.append(f"FUSED {pre}/fused/slot_buffers: "
                     f"{int(fused_n['value'])} (L*k, .) buffer(s) in the "
                     "saved-residual set; the fused path must save none")
    if fused_t["value"] > ref_t["value"]:
        fails.append(f"FUSED {pre}/fused/time: {fused_t['value']:.0f}us vs "
                     f"unfused pallas {ref_t['value']:.0f}us in the same "
                     "run; the fused kernels must not be slower")
    return fails


def parallel_bench_config():
    """The MoE shape the ``parallel/*`` family benches: h ≈ 3d with a tight
    exchange capacity — the region where the cost model predicts the token
    exchange beats replicated EP outright.  h % 4 != 0 keeps tp out of the
    ranking on the 4-way model axis, mirroring the awkward-ff paper
    configs.  The ranks run on the CPU, where ``ragged`` refuses float32
    (and h = 198 rows are not 16-byte aligned for it either), so the
    expert GEMMs take ``segment``."""
    from repro_torch.configs import get_config
    return get_config("mixtral_8x7b").reduced().replace(
        num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
        vocab_size=128, sliding_window=16, attn_chunk=16,
        num_experts=8, top_k=2, d_model=64, moe_d_ff=198,
        moe_a2a_capacity=1.0, gmm_backend="segment")


#: the ranks of the ``parallel/*`` family: (data, model) = (2, 4), gloo on
#: the CPU, as the reference runs 8 host devices
PARALLEL_MESH = ((2, 4), ("data", "model"))

#: how long a spawned rank may wait for its peers
_RANK_TIMEOUT_S = 300


def _parallel_rank(rank: int, world: int, workdir: str) -> None:
    """One spawned rank of :func:`parallel_entries`: times fwd+grad of
    ``moe_sublayer`` under each job mode on its slab (barrier before and
    after each call, the modes interleaved round by round) and writes its
    samples to ``rank<r>.pkl``."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    import torch.distributed as dist

    from repro_torch import sharding as SH
    from repro_torch.configs.base import ModelConfig
    from repro_torch.launch.mesh import Mesh, init_distributed
    from repro_torch.models.moe_block import moe_sublayer

    torch.set_num_threads(1)
    work = Path(workdir)
    job = pickle.loads((work / "job.pkl").read_bytes())
    init_distributed("cpu", init_method=f"file://{work / 'store'}",
                     timeout=timedelta(seconds=_RANK_TIMEOUT_S))
    mesh = Mesh(*PARALLEL_MESH)
    cfg0 = ModelConfig(**job["cfg"])
    x = job["x"]
    dp = ("data",)
    rows = x.shape[0] // mesh.axis_size(dp)
    lo = mesh.flat_index(dp) * rows
    xl = x[lo:lo + rows].clone().requires_grad_(True)
    steps = {}
    for label, mode, chunks in job["cases"]:
        cfg = cfg0.replace(moe_parallel=mode, moe_a2a_chunks=chunks)
        pl = SH.local_params({"moe": job["p"]}, mesh, mode)["moe"]
        names = sorted(pl)
        leaves = [pl[k].clone().requires_grad_(True) for k in names]

        def step(cfg=cfg, names=names, leaves=leaves):
            p = dict(zip(names, leaves))
            y, _ = moe_sublayer(xl, p, cfg, mesh=mesh, dp_axes=dp)
            loss = (y.float() ** 2).mean()
            return torch.autograd.grad(loss, [xl] + leaves)
        steps[label] = step

    # the modes interleaved, one call each a round, so that a slow spell
    # of the shared host falls on every mode alike
    out = {label: [] for label in steps}
    for i in range(job["warmup"] + job["iters"]):
        for label, step in steps.items():
            dist.barrier()
            t0 = time.perf_counter()
            step()
            dist.barrier()
            if i >= job["warmup"]:
                out[label].append((time.perf_counter() - t0) * 1e6)
    (work / f"rank{rank}.pkl").write_bytes(pickle.dumps(out))
    dist.destroy_process_group()


def _spawn_parallel(job: dict) -> list[dict]:
    """Run ``job`` on the mesh's ranks, spawned as gloo processes on the
    CPU; returns each rank's samples.  A rank that fails fails the
    spawn."""
    import torch.multiprocessing as mp
    world = math.prod(PARALLEL_MESH[0])
    work = Path(tempfile.mkdtemp(prefix="repro_torch_bench_"))
    try:
        (work / "job.pkl").write_bytes(pickle.dumps(job))
        mp.start_processes(_parallel_rank, args=(world, str(work)),
                           nprocs=world, join=True, start_method="spawn")
        return [pickle.loads((work / f"rank{r}.pkl").read_bytes())
                for r in range(world)]
    finally:
        shutil.rmtree(work, ignore_errors=True)


def parallel_entries(L: int = 2048, iters: int = 5) -> list:
    """MoE distribution modes timed on the 2 data x 4 model mesh, eight
    gloo ranks spawned on the CPU (the reference's 8 host devices), next to
    the cost model's predictions (``roofline.select_moe_parallel``, the
    H100's constants) for the SAME config x mesh x slab — the measurement
    half of the ``auto`` optimizer's validation loop.

    Per mode: the median over iterations of one fwd+grad call of
    ``moe_sublayer`` on every rank, fenced by barriers (informational vs
    the baseline) plus the predicted ``t_total`` entry.
    :func:`parallel_gate_failures` pairs them in the same run: the
    predicted ep vs ep_a2a ranking must agree with the measured one, and
    the chunked path must not be slower than the unchunked exchange."""
    import dataclasses

    from repro_torch import roofline
    from repro_torch.launch.mesh import DryMesh

    cfg = parallel_bench_config()
    mesh = DryMesh(*PARALLEL_MESH)
    decision = roofline.select_moe_parallel(cfg, mesh, L)
    pred = {c.mode: c for c in decision.table}
    gen = torch.Generator().manual_seed(0)
    d, E, h = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    p = {"wg": torch.randn(d, E, generator=gen) * 0.1,
         "w1": torch.randn(E, d, h, generator=gen) / math.sqrt(d),
         "w2": torch.randn(E, d, h, generator=gen) / math.sqrt(d),
         "w3": torch.randn(E, h, d, generator=gen) / math.sqrt(h)}
    x = torch.randn(2, L, d, generator=gen)
    meta = {"L": L, "d": d, "h": h, "E": E, "k": cfg.top_k,
            "capacity": cfg.moe_a2a_capacity, "mesh": "2x4",
            "ranks": "gloo on the CPU"}
    cases = (("ep", "ep", 1), ("ep_a2a", "ep_a2a", 1),
             ("ep_a2a_chunked", "ep_a2a", 2))
    # warmup=2: the first calls carry the allocator's and gloo's warmup,
    # and the chunked gate pairs wall times at a few-percent resolution.
    ranks = _spawn_parallel({"cfg": dataclasses.asdict(cfg), "x": x,
                             "p": p, "cases": cases, "warmup": 2,
                             "iters": iters})

    out = [entry("kernels/parallel/auto_mode",
                 float(decision.mode == "ep_a2a"), kind="count", unit="bool",
                 tolerance_pct=0.0, resolved=decision.mode,
                 source=decision.source, **meta)]
    for label, mode, chunks in cases:
        # the mesh's wall time of an iteration: its slowest rank's
        us = statistics.median(max(r[label][i] for r in ranks)
                               for i in range(iters))
        out.append(entry(f"kernels/parallel/{label}/time", us,
                         kind="time_us", unit="us", chunks=chunks, **meta))
        pc = pred[mode]
        out.append(entry(f"kernels/parallel/{label}/predicted",
                         pc.t_total_s * 1e6 if chunks == 1 else
                         _chunked_predicted_us(cfg, mesh, L, chunks),
                         kind="time_us", unit="us", chunks=chunks,
                         feasible=pc.feasible, **meta))
    return out


def _chunked_predicted_us(cfg, mesh, L, chunks) -> float:
    """Predicted t_total of the chunked-overlap exchange (the cost model
    reads ``cfg.moe_a2a_chunks``)."""
    from repro_torch import roofline
    d = roofline.select_moe_parallel(
        cfg.replace(moe_a2a_chunks=chunks), mesh, L)
    return next(c.t_total_s for c in d.table if c.mode == "ep_a2a") * 1e6


#: measured chunked/unchunked slack: the gloo ranks on the CPU overlap no
#: exchange with compute, so the chunked path only has to hold parity
#: there, not win — and CPU rank wall clocks pair at ~±10% noise, so the
#: gate only catches gross regressions such as a serialized per-chunk sync.
PARALLEL_CHUNK_TOL = 1.25


def parallel_gate_failures(entries: list) -> list:
    """Same-run pairing gates for the ``parallel/*`` family: (1) the cost
    model's predicted ep vs ep_a2a ranking must agree with the measured
    ranking of the SAME run, (2) the chunked exchange must not be slower
    than the unchunked one (within :data:`PARALLEL_CHUNK_TOL` — CPU ranks
    have no overlap to win with), and (3) ``auto`` must have resolved to
    the predicted winner.  Returns human-readable failure lines (empty ==
    all gates hold)."""
    by_name = {e["name"]: e for e in entries}
    pre = "kernels/parallel"
    names = (f"{pre}/ep/time", f"{pre}/ep_a2a/time",
             f"{pre}/ep/predicted", f"{pre}/ep_a2a/predicted",
             f"{pre}/ep_a2a_chunked/time", f"{pre}/auto_mode")
    got = [by_name.get(n) for n in names]
    if all(g is None for g in got):
        # No parallel family at all (legacy/synthetic record): nothing to
        # pair.
        return []
    if any(g is None for g in got):
        return [f"PARALLEL {pre}/* family incomplete in this run "
                "(regenerate the record with the current suite)"]
    ep_t, a2a_t, ep_p, a2a_p, ch_t, auto = (g["value"] for g in got)
    fails = []
    if (ep_p < a2a_p) != (ep_t < a2a_t):
        fails.append(
            f"PARALLEL predicted ranking disagrees with measured: "
            f"predicted ep={ep_p:.0f}us vs ep_a2a={a2a_p:.0f}us, measured "
            f"ep={ep_t:.0f}us vs ep_a2a={a2a_t:.0f}us in the same run")
    if ch_t > a2a_t * PARALLEL_CHUNK_TOL:
        fails.append(
            f"PARALLEL {pre}/ep_a2a_chunked/time: {ch_t:.0f}us vs unchunked "
            f"{a2a_t:.0f}us in the same run; the chunked-overlap path must "
            f"not be slower (tol {PARALLEL_CHUNK_TOL:.2f}x)")
    want = "ep" if ep_p < a2a_p else "ep_a2a"
    resolved = by_name[f"{pre}/auto_mode"]["meta"].get("resolved")
    if resolved != want:
        fails.append(
            f"PARALLEL auto resolved to {resolved!r} but the cost model's "
            f"predicted winner in the same run is {want!r}")
    return fails


def train_step_entries(steps: int = 3, *, device=None) -> list:
    """Per-step wall time of the tiny-config train loop, collected through
    ``train.loop``'s ``step_hook`` (the hook the harness regresses
    against)."""
    from repro_torch.bench.memory import bench_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.train.loop import train

    dev = resolve_device(device)
    cfg = bench_config()
    tcfg = TrainConfig(total_steps=steps + 1, batch_size=2, seq_len=32,
                       log_every=10_000)
    times, backends = [], []

    def hook(step, m):
        times.append(m["step_s"])
        backends.append(m["gmm_backend"])   # resolved name, not the env var

    train(cfg, tcfg, device=dev, log=lambda *_: None, step_hook=hook)
    # First step includes the kernels' first calls; report the median of
    # the rest.
    us = statistics.median(times[1:]) * 1e6
    return [entry(f"kernels/train_step/{cfg.name}/time", us,
                  kind="time_us", unit="us", steps=steps,
                  compile_s=times[0], gmm_backend=backends[-1])]


def kernels_suite(*, small: bool = False, device=None) -> list:
    """All timing-axis entries.  ``small`` is the CI/test sweep.  On the
    card every sweep includes the ``pallas`` backend (the hand-written
    kernels); on the CPU, as the reference's interpret mode, only the
    small one."""
    dev = resolve_device(device)
    out = []
    out += swiglu_traffic_entries(L=1024 if small else 4096, device=dev)
    out += pallas_kernel_entries(L=256 if small else 1024,
                                 iters=3 if small else 5, device=dev)
    out += gmm_backend_entries(S=512 if small else 2048,
                               iters=3 if small else 5,
                               include_pallas=small or dev.type == "cuda",
                               device=dev)
    out += fused_path_entries(L=64 if small else 128,
                              iters=3 if small else 5, device=dev)
    # The parallel family keeps L=2048 even in the small sweep, as the
    # reference's: at L=1024 the chunked exchange's per-hop fixed overhead
    # dominates the halved chunk and the parity gate turns into a coin flip.
    out += parallel_entries(L=2048, iters=3 if small else 5)
    out += train_step_entries(device=dev)
    return out


def legacy_rows(entries: list) -> list:
    """Project record entries onto the old ``(name, us, derived)`` CSV rows
    of the reference's ``benchmarks/run.py``."""
    rows = []
    for e in entries:
        us = e["value"] if e["kind"] == "time_us" else 0.0
        derived = ";".join(f"{k}={v}" for k, v in e["meta"].items())
        if e["kind"] != "time_us":
            derived = f"{e['kind']}={e['value']:.4g};{derived}"
        rows.append((e["name"].replace("/", "_"), us, derived.rstrip(";")))
    return rows
