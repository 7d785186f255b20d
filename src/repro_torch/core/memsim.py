"""Static per-phase peak-memory simulator for one train step, and the
capacity arithmetic of the ``ep_a2a`` exchanges.

Mirrors ``repro/core/memsim.py`` line for line.  The step is walked as a
sequence of phases (the forward per block kind x layer, the loss, the
backward per layer in reverse with the plan's recompute, including the MoE
layer's ``x``-mode replay GEMMs, the optimizer update) into a per-device
peak-bytes timeline, so :meth:`CheckpointPlan.fit` can rank candidates by
simulated *peak*.  The serving timeline (:func:`simulate_serve`) and the KV
byte functions price the paged pools.  ``_a2a_capacity``, ``_a2a_rows``
and ``_a2a_hier_rows`` also size the distributed MoE path's buffers.

``GRAD_FACTOR``, ``FULL_SAVE_FACTOR`` and ``LOSS_FACTOR`` are the
reference's, calibrated there against XLA's ``memory_analysis()``; they are
carried over only so that the port computes what the reference computes.
How well they describe PyTorch's allocator on the H100 is measured
(``chip_smoke.py``'s plan sweep prints each plan's measured peak beside the
simulated one); they are not refit here.

Everything is shape arithmetic on the config: no tensor is made.
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core import checkpoint as CK

# -- the reference's calibrated constants (see the module docstring) -------

#: cotangent working set per layer-bwd, as a fraction of the layer's
#: forward working set.
GRAD_FACTOR = 1.0

#: held-residual multiplier under ``special="full"``: the reference's
#: compiled step keeps elementwise intermediates (norm stats, silu inputs,
#: residual adds) beyond the enumerable tagged tensors.
FULL_SAVE_FACTOR = 1.9

#: how many logits-sized buffers are live around the loss phase: the f32
#: logits, the log-softmax statistics, and the logits cotangent.
LOSS_FACTOR = 3


@dataclass(frozen=True)
class Phase:
    """One step of the simulated timeline.  ``live_bytes`` excludes the
    timeline's ``base_bytes`` (params/grads/optimizer — constant over the
    step); the timeline's ``peak_bytes`` adds it back."""

    name: str                   # "fwd/attn_moe[0]", "loss", "bwd/...", ...
    held_bytes: int             # residuals held across this phase
    transient_bytes: int        # working set materialized during the phase
    collective_bytes: int = 0   # a2a capacity buffers live in the phase

    @property
    def live_bytes(self) -> int:
        return self.held_bytes + self.transient_bytes + self.collective_bytes


@dataclass(frozen=True)
class MemTimeline:
    """The simulated per-device timeline of one train step."""

    phases: tuple[Phase, ...]
    base_bytes: int             # params (+grads, +opt state) per device
    base: str                   # "acts" | "grad" | "train"
    mode: str             # "single" | "ep" | "ep_a2a" | "ep_a2a_hier" | "tp"
    n_model: int
    recompute_bytes: int        # total plan-driven recompute across bwd

    @property
    def peak_bytes(self) -> int:
        return self.base_bytes + max(p.live_bytes for p in self.phases)

    @property
    def peak_phase(self) -> str:
        return max(self.phases, key=lambda p: p.live_bytes).name

    def table(self, limit: int | None = None) -> str:
        """Human-readable phase table (README / dryrun records / examples).
        ``limit`` keeps the ``limit`` highest-live phases (peak first)."""
        rows = sorted(self.phases, key=lambda p: -p.live_bytes)
        if limit is not None:
            rows = rows[:limit]
        peak = self.peak_phase
        lines = [f"{'phase':18s} {'held':>12s} {'transient':>12s} "
                 f"{'collective':>12s} {'live':>12s}"]
        for p in rows:
            mark = " *" if p.name == peak else ""
            lines.append(
                f"{p.name:18s} {p.held_bytes:12,d} {p.transient_bytes:12,d} "
                f"{p.collective_bytes:12,d} {p.live_bytes:12,d}{mark}")
        lines.append(f"base (params/opt) {self.base_bytes:12,d}   "
                     f"peak {self.peak_bytes:,d} @ {peak}")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# shape arithmetic
# ---------------------------------------------------------------------------


def _itemsize(dtype) -> int:
    return {"float32": 4, "bfloat16": 2, "float16": 2}.get(str(dtype), 4)


def _layer_kinds(cfg) -> list:
    period = max(len(cfg.block_pattern), 1)
    return [cfg.block_pattern[i % period] for i in range(cfg.num_layers)]


def param_bytes(cfg, *, n_model: int = 1) -> int:
    """Analytic per-device parameter bytes (embed + untied head + per-layer
    projections; expert weights divide by ``n_model`` under ep modes)."""
    p = _itemsize(cfg.param_dtype)
    d, V = cfg.d_model, cfg.vocab_size
    total = 2 * V * d * p + d * p          # embed + head + final norm
    for kind in _layer_kinds(cfg):
        b = 2 * d * p                                 # pre-norms
        if "attn" in kind or kind == "hymba":
            h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
            b += (2 * h + 2 * kv) * d * hd * p
        if kind.endswith("moe"):
            E = cfg.num_experts
            b += d * E * p                            # router
            b += 3 * (E // max(n_model, 1)) * d * cfg.moe_d_ff * p
        elif "attn" in kind or kind == "hymba":
            n_ffn = 3 if cfg.ffn_act == "swiglu" else 2
            b += n_ffn * d * cfg.d_ff * p
        if kind in ("mlstm", "slstm"):
            b += 4 * d * d * p                        # recurrent projections
        total += b
    return total


def _a2a_capacity(cfg, slots: int, n: int, clamp: int | None = None) -> int:
    """Per-destination slot capacity of one a2a hop over ``n`` ranks:
    uniform share of ``slots`` scaled by ``cfg.moe_a2a_capacity``, clamped
    (the traced path in ``models.moe_block`` delegates here)."""
    n = max(n, 1)
    uniform = (slots + n - 1) // n
    cap = int(uniform * float(cfg.moe_a2a_capacity))
    return max(min(cap, clamp if clamp is not None else slots), 1)


def _a2a_rows(cfg, n_tokens: int, n_model: int) -> int:
    """Total rows of the flat ep_a2a send/recv buffers on one device:
    ``n_model * C`` with C the per-destination capacity (mirrors
    ``models.moe_block`` on the L/n_model token chunk).  With
    ``cfg.moe_a2a_chunks > 1`` the capacity rounds up to a chunk multiple,
    exactly as the chunked-overlap path pads it."""
    n = max(n_model, 1)
    chunk = max(n_tokens // n, 1)
    c = _a2a_capacity(cfg, chunk * cfg.top_k, n)
    ch = max(int(getattr(cfg, "moe_a2a_chunks", 1)), 1)
    if ch > 1:
        c = -(-c // ch) * ch
    return n * c


def _a2a_hier_rows(cfg, n_tokens: int, n_node: int, n_lane: int
                   ) -> tuple[int, int]:
    """(hop-1 rows, hop-2 rows) of the two-hop ``ep_a2a_hier`` buffers:
    hop 1 groups this device's ``L/n`` chunk's slots by destination lane
    over the ``n_lane`` intra-node ranks; hop 2 regroups the received rows
    by destination node over ``n_node`` ranks."""
    n = max(n_node, 1) * max(n_lane, 1)
    chunk = max(n_tokens // n, 1)
    slots = chunk * cfg.top_k
    c1 = _a2a_capacity(cfg, slots, n_lane)
    r1 = max(n_lane, 1) * c1
    c2 = _a2a_capacity(cfg, slots, n_node, clamp=r1)
    return r1, max(n_node, 1) * c2


@dataclass(frozen=True)
class _KindSizes:
    """Forward working-set components of one layer of one block kind."""

    attn: int = 0           # q/k/v, scores, attention out, o-proj, norms
    ffn: int = 0            # dense-FFN a, b, y_swi, y
    moe_other: int = 0      # router logits, dispatch indices, x_g, y_g, y
    moe_vjp: int = 0        # grouped-GEMM interior: a, b, y_swi (slot rows)
    moe_vjp_held: int = 0   # ditto at the rows actually routed
    moe_x: int = 0          # the MoE sublayer input (custom-VJP residual x)
    ssm: int = 0            # recurrent-scan carries + gate temps
    collective: int = 0     # a2a send/recv/return row buffers
    dots_extra: int = 0     # matmul outputs beyond the canonical tags

    @property
    def core(self) -> int:
        return (self.attn + self.ffn + self.moe_other + self.moe_vjp
                + self.ssm)


def _kind_sizes(cfg, kind: str, n_tokens: int, batch: int,
                mode: str, n_model: int, n_node: int = 1) -> _KindSizes:
    it = _itemsize(cfg.dtype)
    d = cfg.d_model
    x_b = n_tokens * d * it
    seq = max(n_tokens // max(batch, 1), 1)
    n_exp = max(n_model, 1) * max(n_node, 1)          # expert-parallel ways
    attn = ffn = moe_other = moe_vjp = moe_vjp_held = moe_x = ssm = 0
    collective = dots_extra = 0
    if "attn" in kind or kind == "hymba":
        h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
        qkv = n_tokens * (h + 2 * kv) * hd * it
        scores = batch * h * seq * seq * it
        attn = qkv + scores + 2 * x_b + 2 * x_b      # av+o out, 2 norms
        dots_extra += scores
    if kind.endswith("moe"):
        E, k, ff = cfg.num_experts, cfg.top_k, cfg.moe_d_ff
        E_loc = E // n_exp if mode in ("ep", "ep_a2a", "ep_a2a_hier") else E
        if mode == "ep_a2a" and n_exp > 1:
            tm = max(n_tokens // n_exp, 1)            # this device's chunk
            rows = _a2a_rows(cfg, n_tokens, n_exp)    # capacity-padded
            rows_held = tm * k                        # rows actually routed
            ch = max(int(getattr(cfg, "moe_a2a_chunks", 1)), 1)
            if ch > 1:
                # Double-buffered chunks: the full send buffer and the full
                # return buffer stay live, but only two Cc-row exchange
                # chunks (current + prefetched next) are in flight at once.
                collective = (2 * rows + 2 * (rows // ch)) * d * it
            else:
                collective = 3 * rows * d * it        # send_x/recv_x/back
        elif mode == "ep_a2a_hier" and n_exp > 1:
            tm = max(n_tokens // n_exp, 1)
            r1, r2 = _a2a_hier_rows(cfg, n_tokens, n_node, n_model)
            rows = r2                                 # rows the GEMMs run on
            rows_held = tm * k
            # hop-1 send/recv + hop-2 send/recv + the return buffer of the
            # hop live at the peak (the two inverse hops reuse the same
            # footprint on the way back).
            collective = (2 * r1 + 3 * r2) * d * it
        else:
            tm = n_tokens
            rows = rows_held = n_tokens * k           # full slot count
        ff_loc = ff // max(n_model, 1) if mode == "tp" else ff
        moe_other = (tm * E * it                      # router logits
                     + 3 * rows * 4                   # eti/tim/dest indices
                     + 2 * rows * d * it              # x_g, y_g
                     + x_b)                           # combined output y
        moe_vjp = 3 * rows * ff_loc * it              # a, b, y_swi
        moe_vjp_held = 3 * rows_held * ff_loc * it
        moe_x = tm * d * it
        # The segment grouped-GEMM backend's per-expert full-slot dots —
        # what ``dots`` ends up saving on MoE layers in the reference.
        dots_extra += E_loc * (2 * rows * ff_loc + rows * d) * it
    elif "attn" in kind or kind == "hymba":
        n_ffn = 3 if cfg.ffn_act == "swiglu" else 2
        ffn = n_ffn * n_tokens * cfg.d_ff * it + x_b
    if kind in ("mlstm", "slstm", "hymba"):
        ssm = 3 * CK._ssm_state_bytes(cfg, kind, n_tokens, batch) + 2 * x_b
    return _KindSizes(attn=attn, ffn=ffn, moe_other=moe_other,
                      moe_vjp=moe_vjp, moe_vjp_held=moe_vjp_held,
                      moe_x=moe_x, ssm=ssm, collective=collective,
                      dots_extra=dots_extra)


def moe_layer_sizes(cfg, n_tokens: int, *, mode: str, n_model: int = 1,
                    n_node: int = 1) -> _KindSizes:
    """Forward working-set components of ONE MoE layer under ``mode`` —
    the per-device live-bytes half of ``roofline.select_moe_parallel``'s
    ranking (the simulator stays the single source of buffer arithmetic)."""
    return _kind_sizes(cfg, "moe", n_tokens, 1, mode, n_model, n_node)


def _held_bytes(plan, kind: str, sizes: _KindSizes, tag_sizes: dict,
                wrapped: bool) -> int:
    """Residual bytes one layer of ``kind`` holds across fwd->bwd under
    ``plan``.  ``wrapped`` is False for ``full`` (no checkpoint region around
    the layer): the MoE custom-VJP residuals then persist; under any
    wrapped plan they are transient (rebuilt by the bwd replay)."""
    if plan.special == "full":
        held = int(FULL_SAVE_FACTOR
                   * (sizes.attn + sizes.ffn + sizes.moe_other + sizes.ssm))
        held += _vjp_resid_bytes(plan, kind, sizes)
        return held
    if plan.special == "dots":
        saved = sum(tag_sizes.get(t, 0)
                    for t in (CK.QKV, CK.ATTN_OUT, CK.FFN_A, CK.FFN_B))
        return saved + sizes.dots_extra
    saved = sum(tag_sizes.get(t, 0) for t in CK.kind_tags(kind)
                if t in plan.scoped_saved(kind))
    return saved


def _vjp_resid_bytes(plan, kind: str, sizes: _KindSizes) -> int:
    """Persistent MoE custom-VJP residual bytes under an unwrapped plan,
    by residual mode (ab_yswi / ab / x)."""
    if not kind.endswith("moe"):
        return 0
    mode = _vjp_mode(plan)
    if mode == "ab_yswi":
        return sizes.moe_vjp_held + sizes.moe_x
    if mode == "ab":
        return sizes.moe_vjp_held * 2 // 3 + sizes.moe_x
    return sizes.moe_x                                # "x": replay in bwd


def _vjp_mode(plan, save_yswi: bool = True) -> str:
    """Plan-level mirror of :func:`checkpoint.moe_residual_mode` (which
    reads the plan off a config): the MoE custom-VJP residual set."""
    oa = plan.override_for(CK.FFN_A, CK.MOE_SCOPE_KINDS)
    oy = plan.override_for(CK.FFN_YSWI, CK.MOE_SCOPE_KINDS)
    if oa == CK.RECOMPUTE:
        return "x"
    save_y = save_yswi if oy is None else oy == CK.SAVE
    return "ab_yswi" if save_y else "ab"


# ---------------------------------------------------------------------------
# the simulator
# ---------------------------------------------------------------------------


def simulate(cfg, n_tokens: int, *, batch: int = 1, plan=None,
             mode: str | None = None, n_model: int = 1, n_node: int = 1,
             base: str = "grad") -> MemTimeline:
    """Simulate one train step's per-device memory timeline.

    ``n_tokens`` / ``batch`` are the *per-device* token and sequence counts
    (the caller divides the global batch by its data-parallel shards and
    microbatches, exactly as :func:`train.loop.make_train_step` does for the
    residual estimate).  ``mode`` / ``n_model`` / ``n_node`` pick the MoE
    distribution (``single`` | ``ep`` | ``ep_a2a`` | ``ep_a2a_hier`` |
    ``tp``; ``n_node`` is the factored cross-node tier of a node mesh, 1
    when absent); ``base`` selects what constant state sits under the
    activation timeline:

    * ``"acts"``  — activations only (plan comparisons in isolation);
    * ``"grad"``  — params + grads + batch (what the reference calibrated
      against its compiled step's memory analysis);
    * ``"train"`` — adds AdamW m/v and an optimizer-update phase: the
      budget-relevant per-device train-step peak.
    """
    if base not in ("acts", "grad", "train"):
        raise ValueError(f"unknown base {base!r}; use acts|grad|train")
    if isinstance(plan, CK.CheckpointPlan):
        plan = plan
    else:
        plan = CK.resolve_plan(plan, config=cfg.remat_policy).plan
    if mode is None:
        mode = "single" if n_model * n_node <= 1 else (
            cfg.moe_parallel
            if cfg.moe_parallel in ("ep", "ep_a2a", "ep_a2a_hier", "tp")
            else "ep")
    if mode not in ("single", "ep", "ep_a2a", "ep_a2a_hier", "tp"):
        raise ValueError(f"unknown moe-parallel mode {mode!r}")

    it = _itemsize(cfg.dtype)
    x_b = n_tokens * cfg.d_model * it
    logits_b = n_tokens * cfg.vocab_size * 4          # f32 log_softmax
    kinds = _layer_kinds(cfg)
    tag_by_kind = {k: s for k, s in
                   CK.tag_bytes_by_kind(cfg, n_tokens, batch=batch)}
    sizes_of = {k: _kind_sizes(cfg, k, n_tokens, batch, mode, n_model,
                               n_node)
                for k in set(kinds)}
    wrapped = plan.special != "full"
    vjp_mode = _vjp_mode(plan, cfg.save_yswi)

    held, spikes, recs = [], [], []
    for k in kinds:
        s = sizes_of[k]
        h = _held_bytes(plan, k, s, tag_by_kind.get(k, {}), wrapped)
        if wrapped:
            rec = max(s.core - h, 0)
        else:
            rec = 0
        replay = 0
        if k.endswith("moe") and not wrapped:
            if vjp_mode == "x":                       # rebuild A, B, Y_swi
                replay = s.moe_vjp
            elif vjp_mode == "ab":                    # rebuild Y_swi only
                replay = s.moe_vjp // 3
        held.append(h)
        spikes.append(rec + replay + int(GRAD_FACTOR * s.core))
        recs.append(rec + replay)

    phases = []
    for i, k in enumerate(kinds):
        s = sizes_of[k]
        phases.append(Phase(
            name=f"fwd/{k}[{i}]",
            held_bytes=(i + 2) * x_b + sum(held[:i]),
            transient_bytes=s.core,
            collective_bytes=s.collective))
    all_held = (len(kinds) + 2) * x_b + sum(held)
    phases.append(Phase(name="loss", held_bytes=all_held,
                        transient_bytes=LOSS_FACTOR * logits_b))
    for i in reversed(range(len(kinds))):
        k = kinds[i]
        s = sizes_of[k]
        phases.append(Phase(
            name=f"bwd/{k}[{i}]",
            held_bytes=(i + 2) * x_b + sum(held[:i + 1]),
            transient_bytes=spikes[i],
            collective_bytes=s.collective))

    # Expert weights per device: ep modes shard the expert dim over the
    # combined node x model axes; tp shards the per-expert hidden dim over
    # 'model' — either way the bank divides by that many ways.
    ep_ways = (n_model * n_node
               if mode in ("ep", "ep_a2a", "ep_a2a_hier") else n_model)
    pb = param_bytes(cfg, n_model=max(ep_ways, 1))
    n_params = pb // _itemsize(cfg.param_dtype)
    grads_b = n_params * 4
    tok_b = 2 * n_tokens * 4
    base_b = 0
    if base in ("grad", "train"):
        base_b = pb + grads_b + tok_b
    if base == "train":
        base_b += 2 * n_params * 4                    # AdamW m, v
        phases.append(Phase(name="optimizer", held_bytes=0,
                            transient_bytes=n_params * 4))
    return MemTimeline(phases=tuple(phases), base_bytes=base_b, base=base,
                       mode=mode, n_model=n_model,
                       recompute_bytes=sum(recs))


# ---------------------------------------------------------------------------
# serve mode: paged KV cache + inference activations
# ---------------------------------------------------------------------------


def _kv_kinds(cfg) -> list:
    """Layer kinds that carry a KV cache."""
    return [k for k in _layer_kinds(cfg) if "attn" in k or k == "hymba"]


def kv_bytes_per_token(cfg, *, quantized: bool = False,
                       dtype: str | None = None) -> int:
    """KV-cache bytes ONE cached token costs across all layers.  ``dtype``
    overrides the storage dtype for the unquantized case (e.g. compare a
    bf16 dense baseline against an int8 paged pool on an f32 config);
    ``quantized`` prices the int8 + f16-scale layout of
    ``serve/paged_cache`` / ``serve/kv_quant``."""
    kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    if quantized:
        per_layer = 2 * kv * hd + 2 * kv * 2          # int8 k/v + f16 scales
    else:
        per_layer = 2 * kv * hd * _itemsize(dtype or cfg.dtype)
    return per_layer * len(_kv_kinds(cfg))


def kv_page_bytes(cfg, num_pages: int, page_size: int, *,
                  quantized: bool = False) -> int:
    """Total bytes of the block-paged KV pools (``T.init_paged_cache``):
    every page of every layer, allocated up front — the serve-mode
    equivalent of the training residual base."""
    return num_pages * page_size * kv_bytes_per_token(cfg,
                                                      quantized=quantized)


def dense_slot_bytes(cfg, batch_slots: int, capacity: int, *,
                     dtype: str | None = None) -> int:
    """The seed engine's dense per-slot cache (``T.init_cache``): every slot
    pins ``capacity`` positions whether or not a request ever reaches them —
    the baseline the paged pool is gated against."""
    return batch_slots * capacity * kv_bytes_per_token(cfg, dtype=dtype)


def simulate_serve(cfg, *, batch_slots: int, num_pages: int, page_size: int,
                   prefill_tokens: int, prefill_batch: int = 1,
                   quantized: bool = False, shared_pages: int = 0,
                   n_model: int = 1) -> MemTimeline:
    """Simulate the serving engine's per-device memory timeline.

    Two phases — ``prefill`` (whole-prompt forward at ``prefill_tokens``
    total tokens over ``prefill_batch`` sequences) and ``decode`` (one
    single-token step over the full slot array).  The paged KV pool is the
    *held* set of both phases (allocated once, resident for the engine's
    life); transients are the largest single layer's forward working set —
    inference holds no residuals, so layers reuse their buffers — plus, for
    decode, the per-request page-gather views ``(B, pages_per_seq *
    page_size, Hkv, Dh)`` that ``paged_attention`` materializes.  Same
    shape arithmetic as :func:`simulate`.

    ``shared_pages`` models prefix-cache hits (``prefix_cache=True``
    engines): each sequence in the prefill batch maps that many full prompt
    pages read-only from the cache, so only the unshared suffix is
    forwarded — the prefill transient shrinks by ``shared_pages *
    page_size`` tokens per sequence.  The pool's held bytes do NOT shrink
    (the pool is sized at construction); sharing shows up as fewer pages
    *consumed* per request, i.e. headroom, which the engine reports as
    ``stats['shared_pages_mapped']``.
    """
    it = _itemsize(cfg.dtype)
    prefill_tokens = max(
        prefill_tokens - shared_pages * page_size * prefill_batch,
        prefill_batch)
    pool_b = kv_page_bytes(cfg, num_pages, page_size, quantized=quantized)
    mode = "single" if n_model <= 1 else "ep"
    kinds = set(_layer_kinds(cfg))

    def layer_transient(n_tokens: int, batch: int) -> int:
        x_b = n_tokens * cfg.d_model * it
        return max(_kind_sizes(cfg, k, n_tokens, batch, mode, n_model).core
                   + 2 * x_b for k in kinds)

    logits_b = batch_slots * cfg.vocab_size * 4
    # page-table width: the engine's default budget is full occupancy
    # (num_pages = 1 + slots * pages_per_seq), so invert that here
    pages_per_seq = -(-(num_pages - 1) // max(batch_slots, 1))
    gather_tokens = batch_slots * pages_per_seq * page_size
    gather_b = 2 * gather_tokens * cfg.num_kv_heads * cfg.resolved_head_dim \
        * (1 if quantized else it)
    if quantized:
        gather_b += 2 * gather_tokens * cfg.num_kv_heads * 2   # f16 scales
    phases = (
        Phase(name="prefill", held_bytes=pool_b,
              transient_bytes=layer_transient(prefill_tokens, prefill_batch)
              + prefill_batch * cfg.vocab_size * 4),
        Phase(name="decode", held_bytes=pool_b,
              transient_bytes=layer_transient(batch_slots, batch_slots)
              + gather_b + logits_b),
    )
    return MemTimeline(phases=phases,
                       base_bytes=param_bytes(cfg, n_model=n_model),
                       base="acts", mode=mode, n_model=n_model,
                       recompute_bytes=0)


def simulate_peak(cfg, n_tokens: int, *, batch: int = 1, plan=None,
                  mode: str | None = None, n_model: int = 1,
                  n_node: int = 1, base: str = "grad") -> int:
    """Peak bytes of :func:`simulate` (the fit and train-step scalar)."""
    return simulate(cfg, n_tokens, batch=batch, plan=plan, mode=mode,
                    n_model=n_model, n_node=n_node, base=base).peak_bytes
