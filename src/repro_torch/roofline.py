"""The roofline cost model that resolves ``moe_parallel="auto"``, and the
analytic yardsticks beside it.

Mirrors the analytic half of ``repro/roofline.py``: ``model_flops``
(``:78-105``), the MoE-parallelism collective cost model (``:167-417``:
``ParallelCost``, ``ParallelDecision``, ``moe_parallel_costs``,
``select_moe_parallel``) and ``select_moe_tiles`` (``:419-487``), as pure
Python.  Every function takes the device's constants as ``hw``
(:class:`~repro_torch.launch.mesh.Hardware`, default ``H100_SXM``): the
reference's are a TPU's, and its tests pass them in to hold the two models
to each other.

The half that reads XLA's compiled module has its counterparts over the
dry run's trace (``compat.trace_step``): :func:`collective_stats` over a
``collectives.Recording`` and :func:`analyze` for
``analyze_compiled``; :func:`bench_entries` projects that dict into the
port's bench records (``repro_torch/bench/record.py``).

The model ranks the candidate modes on ONE MoE layer at the per-device
token slab, with three terms in seconds:

  compute    = grouped-GEMM + gating + dispatch-build flops / peak FLOP/s
  memory     = working-set HBM traffic (twice the dispatch / GEMM buffers,
               one read of the local weight bank) / HBM bandwidth
  collective = bytes on the wire per axis / that axis's bandwidth: a psum
               ring moves 2 (n-1)/n of the tensor per device, an a2a hop
               (n-1)/n of each capacity buffer each way; 'node' and 'pod'
               are charged at the network's rate, the rest at the
               intra-node one (``launch.mesh.axis_bandwidth``).

The buffer row counts come from ``core/memsim.py``, so the predictor and
the peak simulator agree on what a mode allocates.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

from repro_torch.core import memsim
from repro_torch.launch.mesh import H100_SXM, Hardware, axis_bandwidth

#: the reference's collective kinds (``repro/roofline.py:34-35``)
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")


def collective_stats(rec) -> dict:
    """Result bytes and counts per collective kind of a
    ``collectives.Recording``, with the reference's keys (``bytes``,
    ``counts``, ``total_bytes``, ``total_count``): every call counted once
    with its result's bytes, the reference's convention.  The five kinds
    always appear; a kind the reference has no name for (``gather``)
    appears when it was called."""
    stats = {k: 0 for k in COLLECTIVES}
    counts = {k: 0 for k in COLLECTIVES}
    for kind, nbytes, _ in rec.calls:
        stats[kind] = stats.get(kind, 0) + nbytes
        counts[kind] = counts.get(kind, 0) + 1
    return {"bytes": stats, "counts": counts,
            "total_bytes": sum(stats.values()),
            "total_count": sum(counts.values())}


def analyze(trace, cfg, shape, *, n_chips: int,
            hw: Hardware = H100_SXM) -> dict:
    """The counterpart of the reference's ``analyze_compiled``
    (``repro/roofline.py:108-165``) over a ``compat.StepTrace`` of one
    rank, with every key of its dict and ``alias_bytes`` and
    ``collective_bytes_by_axes`` beside them.  Where the origin differs
    from XLA's:

      * ``flops_per_dev``: aten's products
        and attention plus the kernels' operations (``kernels/cost.py``),
        where XLA's cost analysis counts every HLO op;
      * ``hlo_bytes_per_dev``: the traced bytes, each aten op's inputs
        and outputs once (no fusion assumed) plus the kernels' bytes;
      * ``collective_*``: the collectives the rank called
        (``core/collectives.recording``), result bytes, where XLA's are
        parsed from the compiled module;
      * ``arg_bytes`` / ``out_bytes`` / ``temp_bytes`` / ``peak_bytes``:
        the live-storage accounting of ``compat.trace_step``, where XLA's
        are its buffer assignment;
      * ``fits_hbm`` against ``hw.hbm_bytes``; the times at ``hw``'s
        peak rate, HBM rate and ``intra_node_bw``."""
    coll = collective_stats(trace.collectives)
    mf = model_flops(cfg, global_batch=shape.global_batch,
                     seq_len=shape.seq_len, kind=shape.kind)
    flops, hbm = trace.flops, trace.bytes_accessed
    t_compute = flops / hw.peak_flops_bf16
    t_memory = hbm / hw.hbm_bw
    t_coll = coll["total_bytes"] / hw.intra_node_bw
    dominant = max((("compute", t_compute), ("memory", t_memory),
                    ("collective", t_coll)), key=lambda kv: kv[1])[0]
    return {
        "flops_per_dev": flops,
        "hlo_bytes_per_dev": hbm,
        "collective_bytes": coll["total_bytes"],
        "collective_counts": coll["counts"],
        "collective_bytes_by_kind": coll["bytes"],
        "collective_bytes_by_axes": trace.collectives.bytes_by_axes(),
        "arg_bytes": trace.arg_bytes, "out_bytes": trace.out_bytes,
        "temp_bytes": trace.temp_bytes, "alias_bytes": trace.alias_bytes,
        "peak_bytes": trace.peak_bytes,
        "fits_hbm": bool(trace.peak_bytes <= hw.hbm_bytes),
        "t_compute_s": t_compute, "t_memory_s": t_memory,
        "t_collective_s": t_coll, "dominant": dominant,
        "model_flops_global": mf,
        "useful_flops_ratio": mf / max(flops * n_chips, 1.0),
        "n_chips": n_chips,
    }


#: modes the optimizer ranks, in tie-break order (earlier wins a tie)
MOE_MODE_ORDER = ("ep", "ep_a2a_hier", "ep_a2a", "tp")

#: a mode within this fraction of the fastest predicted time is a
#: candidate; among candidates the lowest per-device live bytes wins
AUTO_TIME_SLACK = 0.10

#: a live-bytes spread below this is noise: the earliest candidate wins
AUTO_LIVE_EPS = 8 * 1024 * 1024

#: the per-device slab ranked when the caller has no token count yet
DEFAULT_AUTO_TOKENS = 4096

#: int ops per routing slot per pass of the dispatch build, charged as
#: flops (one-hot, cumsum, offset gather)
_DISPATCH_PASSES = 3.0


def model_flops(cfg, *, global_batch: int, seq_len: int,
                kind: str = "train") -> float:
    """6 N D (dense) or 6 N_active D (MoE): the useful-compute yardstick.
    ``kind`` is ``"train"`` (forward and backward), ``"prefill"`` or
    ``"decode"`` (one token a row).  Counts the leaves of the port's
    parameter tree but ``embed`` (a gather, not a product); the leaves of
    a ``moe`` block, the router among them, count as expert weights, as
    the reference counts them."""
    from repro_torch.interop import param_shapes
    n_total = n_expert = 0

    def walk(tree, path):
        nonlocal n_total, n_expert
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, path + (str(k),))
        elif isinstance(tree, list):
            for i, v in enumerate(tree):
                walk(v, path + (str(i),))
        elif path != ("embed",):            # a shape tuple
            size = 1
            for s in tree:
                size *= s
            if cfg.is_moe and "moe" in path:
                n_expert += size
            else:
                n_total += size

    walk(param_shapes(cfg), ())
    if cfg.is_moe and cfg.num_experts:
        n_active = n_total + n_expert * cfg.top_k / cfg.num_experts
    else:
        n_active = n_total
    tokens = global_batch * (seq_len if kind != "decode" else 1)
    mult = 3.0 if kind == "train" else 1.0
    return 2.0 * n_active * tokens * mult


@dataclass(frozen=True)
class ParallelCost:
    """One row of the ``auto`` decision table: the predicted per-layer
    cost of the MoE sublayer under ``mode`` on this config and mesh."""

    mode: str
    feasible: bool
    why: str                    # why not feasible ("" when it is)
    t_compute_s: float
    t_memory_s: float
    t_collective_s: float
    t_total_s: float
    live_bytes: int             # per-device working set and buffers
    a2a_bytes: int              # predicted bytes on the wire, all_to_all
    psum_bytes: int             # predicted bytes on the wire, psum
    chosen: bool = False

    def row(self) -> dict:
        return dataclasses.asdict(self)


@dataclass(frozen=True)
class ParallelDecision:
    """The resolved MoE distribution with its provenance: the concrete
    mode, where it came from (``config``: forced; ``auto``: the cost
    model; ``single``: no mesh or a dense model) and the table it was
    ranked from."""

    mode: str                   # single | ep | ep_a2a | ep_a2a_hier | tp
    source: str                 # "config" | "auto" | "single"
    table: tuple                # ParallelCost rows, in MOE_MODE_ORDER
    n_tokens: int               # the per-device slab ranked at
    mesh_axes: tuple            # ((axis, size), ...)

    def table_rows(self) -> list:
        return [c.row() for c in self.table]


def _psum_cost(n_tokens: int, d: int, it: int, axes,
               hw: Hardware = H100_SXM) -> tuple[int, float]:
    """(bytes on the wire, seconds) of psum-combining an (L, d) partial
    over ``(axis, size)`` pairs: a ring all-reduce per axis."""
    bytes_total, t = 0, 0.0
    for axis, n in axes:
        if n <= 1:
            continue
        b = int(2 * (n - 1) / n * n_tokens * d * it)
        bytes_total += b
        t += b / axis_bandwidth(axis, hw)
    return bytes_total, t


def _a2a_hop_cost(rows: int, n: int, d: int, it: int, axis: str,
                  hw: Hardware = H100_SXM) -> tuple[int, float]:
    """(bytes on the wire, seconds) of one capacity-bounded exchange over
    ``axis``: ``rows`` buffer rows of width d cross twice (x out, y back),
    (n-1)/n of them leaving the device."""
    if n <= 1:
        return 0, 0.0
    b = int(2 * rows * (n - 1) / n * d * it)
    return b, b / axis_bandwidth(axis, hw)


def moe_parallel_costs(cfg, *, n_model: int, n_node: int = 1,
                       n_tokens: int, hw: Hardware = H100_SXM) -> tuple:
    """The predicted :class:`ParallelCost` of every rankable mode for
    (cfg, expert axes, per-device slab)."""
    E, k, d, h = cfg.num_experts, cfg.top_k, cfg.d_model, cfg.moe_d_ff
    it = memsim._itemsize(cfg.dtype)
    n_exp = max(n_model, 1) * max(n_node, 1)
    L = max(int(n_tokens), 1)
    n_mat = 3 if cfg.ffn_act == "swiglu" else 2
    chunks = max(int(getattr(cfg, "moe_a2a_chunks", 1)), 1)

    def tile_pen(width: float) -> float:
        """A GEMM whose minor dimension is ``width`` pads to the next
        multiple of the tile and runs at ``width / pad`` of peak."""
        if width <= 0:
            return 1.0
        tile = hw.gemm_tile
        return float(-(-int(width) // tile) * tile) / float(width)

    def gemm_time(h_eff: float) -> float:
        """Per-device grouped-GEMM seconds: the expert modes split rows by
        expert at full widths; tp keeps every row and slices the hidden
        dim to ``h_eff``, where slivers narrower than a tile waste it."""
        base = 2.0 * n_mat * L * k * d * h / n_exp
        pen = ((n_mat - 1) * tile_pen(h_eff) + tile_pen(d)) / n_mat
        return base * pen / hw.peak_flops_bf16

    w_bytes = n_mat * E * d * h * it / n_exp       # one local-bank read

    def feas(mode: str) -> str:
        if n_exp <= 1 and mode != "tp":
            return "expert axes are 1-way"
        if mode in ("ep", "ep_a2a", "ep_a2a_hier"):
            if E % n_exp:
                return f"E={E} not divisible by {n_exp} expert ways"
        if mode in ("ep_a2a", "ep_a2a_hier") and L % n_exp:
            return f"{L} tokens/device not divisible by {n_exp} ranks"
        if mode == "ep_a2a" and n_node > 1:
            return "flat a2a on a node mesh (use ep_a2a_hier)"
        if mode == "ep_a2a_hier" and n_node <= 1:
            return "mesh declares no 'node' axis"
        if mode == "tp" and n_model > 1 and h % n_model:
            return f"moe_d_ff={h} not divisible by n_model={n_model}"
        return ""

    rows_out = []
    for mode in MOE_MODE_ORDER:
        why = feas(mode)
        t_gemm = gemm_time(h / n_model if mode == "tp" else h)
        s = memsim.moe_layer_sizes(cfg, L, mode=mode, n_model=n_model,
                                   n_node=n_node)
        # tokens this device gates and routes
        tm = max(L // n_exp, 1) if mode in ("ep_a2a", "ep_a2a_hier") else L
        if mode == "ep_a2a":
            rows = memsim._a2a_rows(cfg, L, n_exp)
            disp_ops = tm * k * n_exp + rows * (E // max(n_exp, 1) + 1)
            a2a_b, t_a2a = _a2a_hop_cost(rows, n_exp, d, it, "model", hw)
        elif mode == "ep_a2a_hier":
            r1, r2 = memsim._a2a_hier_rows(cfg, L, n_node, n_model)
            disp_ops = (tm * k * n_model + r1 * (n_node + 1)
                        + r2 * (E // max(n_exp, 1) + 1))
            b1, t1 = _a2a_hop_cost(r1, n_model, d, it, "model", hw)
            b2, t2 = _a2a_hop_cost(r2, n_node, d, it, "node", hw)
            a2a_b, t_a2a = b1 + b2, t1 + t2
        else:
            disp_ops = tm * k * E
            a2a_b, t_a2a = 0, 0.0
        flops_other = 2.0 * tm * d * E + _DISPATCH_PASSES * disp_ops
        # the expert modes combine over every expert axis; tp's partials
        # over 'model' only (node replicas already agree)
        if mode in ("ep", "ep_a2a", "ep_a2a_hier"):
            psum_axes = (("node", n_node), ("model", n_model))
        else:
            psum_axes = (("model", n_model),)
        psum_b, t_psum = _psum_cost(L, d, it, psum_axes, hw)
        hbm = 2.0 * (s.moe_other + s.moe_vjp) + w_bytes
        t_compute = t_gemm + flops_other / hw.peak_flops_bf16
        t_memory = hbm / hw.hbm_bw
        t_coll = t_a2a + t_psum
        if mode == "ep_a2a" and chunks > 1:
            # chunk i's exchange rides under chunk i-1's grouped GEMM: only
            # the pipeline fill of the smaller of the two stays exposed
            overlapped = min(t_a2a, t_gemm)
            t_total = (t_compute + t_memory + t_psum
                       + max(t_a2a, t_gemm) - t_gemm + overlapped / chunks)
        else:
            t_total = t_compute + t_memory + t_coll
        live = s.moe_other + s.moe_vjp + s.moe_x + s.collective
        rows_out.append(ParallelCost(
            mode=mode, feasible=not why, why=why, t_compute_s=t_compute,
            t_memory_s=t_memory, t_collective_s=t_coll, t_total_s=t_total,
            live_bytes=int(live), a2a_bytes=a2a_b, psum_bytes=psum_b))
    return tuple(rows_out)


def select_moe_parallel(cfg, mesh, n_tokens: int | None = None, *,
                        hw: Hardware = H100_SXM) -> ParallelDecision:
    """Rank the MoE distribution modes for (cfg, mesh, per-device slab)
    and resolve ``cfg.moe_parallel`` to a concrete mode.

    ``auto`` takes the fastest predicted mode, except that a feasible mode
    within :data:`AUTO_TIME_SLACK` of it whose live bytes are lower by more
    than :data:`AUTO_LIVE_EPS` wins: predicted time first, memory second.
    A forced mode passes through (``models.moe_block.resolve_moe_parallel``
    validates it) with the same table attached."""
    if mesh is None or not getattr(cfg, "is_moe", False):
        return ParallelDecision(mode="single", source="single", table=(),
                                n_tokens=int(n_tokens or 0), mesh_axes=())
    n_model = mesh.shape.get("model", 1)
    n_node = mesh.shape.get("node", 1)
    L = int(n_tokens) if n_tokens else DEFAULT_AUTO_TOKENS
    table = moe_parallel_costs(cfg, n_model=n_model, n_node=n_node,
                               n_tokens=L, hw=hw)
    mesh_axes = tuple((a, mesh.shape[a]) for a in mesh.axis_names)
    if cfg.moe_parallel != "auto":
        mode, source = cfg.moe_parallel, "config"
    else:
        source = "auto"
        feasible = [c for c in table if c.feasible]
        ep_like = [c for c in feasible if c.mode != "tp"]
        if (not ep_like and n_model * n_node > 1) or not feasible:
            mode = "tp"           # E does not divide the expert axes
        else:
            t0 = min(c.t_total_s for c in feasible)
            cands = [c for c in feasible
                     if c.t_total_s <= t0 * (1.0 + AUTO_TIME_SLACK)]
            spread = (max(c.live_bytes for c in cands)
                      - min(c.live_bytes for c in cands))
            if spread > AUTO_LIVE_EPS:
                mode = min(cands, key=lambda c: c.live_bytes).mode
            else:
                order = {m: i for i, m in enumerate(MOE_MODE_ORDER)}
                mode = min(cands, key=lambda c: order[c.mode]).mode
    table = tuple(dataclasses.replace(c, chosen=c.mode == mode)
                  for c in table)
    return ParallelDecision(mode=mode, source=source, table=table,
                            n_tokens=L, mesh_axes=mesh_axes)


#: shared memory one block may opt in to on an H100 (227 KB)
SMEM_PER_BLOCK = 227 * 1024


def select_moe_tiles(n_rows: int, d: int, h: int, *, dtype_bytes: int = 2,
                     smem_limit_bytes: int = SMEM_PER_BLOCK,
                     hw: Hardware = H100_SXM) -> tuple[int, int]:
    """The reference's intensity-driven ``(bl, bh)`` tile request for a
    gather-GMM / fused-MoE work item, at this device's ridge point.

    Drives nothing in the port: the CUDA kernels' wgmma tiles are fixed by
    their design (``csrc/moe_wgmma.cuh``).  It is kept as the cost model's
    yardstick.  A step multiplies a ``(bl, d)`` row tile by ``(d, bh)``
    weight blocks (and the ``(bh, d)`` down projection), with intensity
    ``AI = 2 bl bh d / ((bl d + 2 d bh + bh d) dtype_bytes)``; of the
    candidates whose operands, float32 accumulator and temporaries fit the
    on-chip limit (here one block's shared memory), the smallest pair
    that reaches the ridge ``peak / HBM bandwidth`` wins, else the one of
    highest intensity; then each tile shrinks toward the problem's
    extents."""
    ridge = hw.peak_flops_bf16 / hw.hbm_bw
    cands = []
    for bl in (128, 256, 512):
        for bh in (128, 256, 512):
            onchip = ((bl * d + 2 * d * bh + bh * d) * dtype_bytes
                      + bl * d * 4          # float32 partial accumulator
                      + 3 * bl * bh * 4)    # a, b, y_swi float32 temps
            if onchip > smem_limit_bytes:
                continue
            ai = (2.0 * bl * bh * d
                  / ((bl * d + 2 * d * bh + bh * d) * dtype_bytes))
            cands.append((ai, bl, bh, bl * bh))
    if not cands:
        return 128, min(128, max(8, h))
    reaching = [c for c in cands if c[0] >= ridge]
    if reaching:
        _, bl, bh, _ = min(reaching, key=lambda c: (c[3], c[1]))
    else:
        _, bl, bh, _ = max(cands, key=lambda c: (c[0], -c[3]))
    while bl > 128 and bl // 2 >= n_rows:
        bl //= 2
    while bh > 128 and bh // 2 >= h:
        bh //= 2
    return bl, bh


def bench_entries(analysis: dict, prefix: str) -> list:
    """Project an :func:`analyze` dict into ``repro_torch.bench.record``
    entries, with the reference's names, kinds and tolerances
    (``repro/roofline.py:488-508``), so roofline-model numbers and measured
    numbers land in the same tracked report (``BENCH_memory.json``)."""
    from repro_torch.bench.record import entry

    meta = {"dominant": analysis["dominant"], "n_chips": analysis["n_chips"]}
    return [
        entry(f"{prefix}/flops", analysis["flops_per_dev"],
              kind="flops", unit="flop", tolerance_pct=20.0, **meta),
        entry(f"{prefix}/hlo_bytes", analysis["hlo_bytes_per_dev"],
              kind="bytes_accessed", unit="bytes", tolerance_pct=100.0),
        entry(f"{prefix}/peak_bytes", analysis["peak_bytes"],
              kind="peak_bytes", unit="bytes", tolerance_pct=100.0),
        entry(f"{prefix}/t_compute", analysis["t_compute_s"],
              kind="roofline_s", unit="s"),
        entry(f"{prefix}/t_memory", analysis["t_memory_s"],
              kind="roofline_s", unit="s"),
        entry(f"{prefix}/t_collective", analysis["t_collective_s"],
              kind="roofline_s", unit="s"),
    ]
