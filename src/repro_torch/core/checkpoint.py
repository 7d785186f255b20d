"""Activation-checkpoint plans (paper §5.2): what a training step keeps
between its forward and its backward, and what it recomputes.

Mirrors ``repro/core/checkpoint.py``.  A :class:`CheckpointPlan` maps each
canonical tensor tag (``FFN_A`` … ``MOE_GATES``) to ``save`` or
``recompute``, optionally scoped per block kind (``attn_ffn``, ``*moe``,
``ssm``, …).  One plan drives every consumer:

  * the checkpoint wrap of the layer groups of the training forward
    (:func:`plan_policies`: one region around each group when the
    decisions are uniform across the block pattern, one per sublayer when
    a tag is decided differently in two kinds that both materialize it,
    none under ``full``);
  * the MoE layer's residual set (:func:`moe_residual_mode`: the paper's
    A/B/Y_swi policy, Algorithm 1), through explicit ``moe``-scoped
    decisions, with ``ModelConfig.save_yswi`` as the fallback alias;
  * the static estimator (:meth:`CheckpointPlan.estimate_saved_bytes`) and
    the budget fit (:meth:`CheckpointPlan.fit`, ranked by
    ``core/memsim.py``'s simulated peak).

Plans are named (``"none"``, ``"paper"``, ``"paper_min"``, ``"full"``,
``"dots"``: the registry) or spelled as specs::

    save=ffn_a,ffn_b,qkv;moe:recompute=ffn_yswi

``resolve_plan`` follows the precedence of ``core/gmm_backend.resolve``:
call-site argument > config field > the ``"none"`` default.  The plan
arithmetic is the reference's, line for line.

Execution.  Where the reference returns a ``jax.checkpoint`` policy, this
module returns a :class:`SavePolicy` (the tags whose producers' outputs
are kept, or ``dots``: every plain matrix product's output).
:func:`checkpoint` runs a function in a non-reentrant
``torch.utils.checkpoint`` region (``use_reentrant=False``): autograd's
saved tensors inside it are dropped after the forward and rebuilt by
running the function again when the backward first needs one.  A policy
that keeps something adds a selective-checkpoint context
(``create_selective_checkpoint_contexts``): the outputs of the ops run
inside a :func:`tagged` scope of a kept tag are stored in the forward and
handed back in the recompute without running the op, so a saved tag's
producer (the QKV projection, the output projection, the FFN's A and B
products) runs once.  Each tagged scope holds exactly one op that is not
a view (the producer), so what is stored is that tensor and nothing
around it.  Everything else in the region, the MoE layer's
custom-backward residuals included, is transient: it lives from the
recompute to the region's backward, as under the reference's remat.
"""

from __future__ import annotations

import fnmatch
import threading
from contextlib import contextmanager
from dataclasses import dataclass
from functools import lru_cache, partial

import torch

# ---------------------------------------------------------------------------
# Canonical tags + block-kind scopes
# ---------------------------------------------------------------------------

FFN_A = "ffn_a"          # first-projection GEMM output (SiLU branch)
FFN_B = "ffn_b"          # gate-branch GEMM output
FFN_YSWI = "ffn_yswi"    # SwiGLU product
ATTN_OUT = "attn_out"    # attention output projection
QKV = "qkv"              # q projection output
SSM_STATE = "ssm_state"  # recurrent-scan carry snapshots
MOE_GATES = "moe_gates"  # router top-k weights

CANON_TAGS = (FFN_A, FFN_B, FFN_YSWI, ATTN_OUT, QKV, SSM_STATE, MOE_GATES)

SAVE = "save"
RECOMPUTE = "recompute"
_DECISIONS = (SAVE, RECOMPUTE)

#: block kinds the reference's model zoo assembles
#: (``ModelConfig.block_pattern``); plans may scope any of them, whether
#: or not the port runs it.
BLOCK_KINDS = ("attn_ffn", "attn_local_ffn", "attn_moe", "attn_local_moe",
               "mlstm", "slstm", "hymba")

#: scope aliases -> the block kinds they cover.  Exact kind names and
#: fnmatch patterns (``*moe``) are also accepted as scopes.
SCOPE_ALIASES = {
    "moe": ("attn_moe", "attn_local_moe"),
    "ffn": ("attn_ffn", "attn_local_ffn", "hymba"),
    "attn": ("attn_ffn", "attn_local_ffn", "attn_moe", "attn_local_moe",
             "hymba"),
    "ssm": ("mlstm", "slstm", "hymba"),
}

#: the kinds whose scoped decisions drive the MoE layer's residual set.
MOE_SCOPE_KINDS = SCOPE_ALIASES["moe"]


def scope_matches(scope: str, kind: str) -> bool:
    """Whether a spec scope covers a block kind (alias, exact, or glob)."""
    if scope in SCOPE_ALIASES:
        return kind in SCOPE_ALIASES[scope]
    if any(ch in scope for ch in "*?["):
        return fnmatch.fnmatchcase(kind, scope)
    return scope == kind


def _validate_scope(scope: str) -> str:
    if scope in SCOPE_ALIASES or scope in BLOCK_KINDS:
        return scope
    if any(ch in scope for ch in "*?["):
        if any(fnmatch.fnmatchcase(k, scope) for k in BLOCK_KINDS):
            return scope
        raise ValueError(
            f"checkpoint-plan scope pattern {scope!r} matches no block kind; "
            f"kinds: {BLOCK_KINDS}")
    raise ValueError(
        f"unknown checkpoint-plan scope {scope!r}; known kinds "
        f"{BLOCK_KINDS}, aliases {tuple(SCOPE_ALIASES)}, or a glob pattern")


def kind_tags(kind: str) -> tuple[str, ...]:
    """Tags materialized in a block kind: the :func:`tagged` sites of
    ``models/`` plus the reference's SSM carries.  Drives scope semantics,
    the group-vs-per-kind choice, and the static estimator."""
    if kind in ("mlstm", "slstm"):
        return (SSM_STATE,)
    if kind == "hymba":
        return (QKV, ATTN_OUT, SSM_STATE, FFN_A, FFN_B, FFN_YSWI)
    if kind.endswith("moe"):
        return (QKV, ATTN_OUT, MOE_GATES)
    return (QKV, ATTN_OUT, FFN_A, FFN_B, FFN_YSWI)


# ---------------------------------------------------------------------------
# CheckpointPlan
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class CheckpointPlan:
    """A per-tag, per-block-kind activation-checkpoint decision map.

    ``saved`` is the default-scope save set (every tag not listed is
    ``recompute``); ``overrides`` are explicit scoped decisions
    ``(scope, tag, decision)`` applied in order (later wins) on top of the
    default for the block kinds the scope matches.  ``special`` marks the
    two policies not expressible as tag sets (``full``, ``dots``).  Frozen
    and hashable."""

    saved: tuple[str, ...] = ()
    overrides: tuple[tuple[str, str, str], ...] = ()
    name: str = ""
    special: str = ""               # "" | "full" | "dots"

    def __post_init__(self):
        if self.special not in ("", "full", "dots"):
            raise ValueError(f"unknown special policy {self.special!r}")
        if self.special and self.saved:
            raise ValueError(
                f"special policy {self.special!r} cannot carry a default "
                "save set (its save decisions are not tag-based); scoped "
                "overrides are allowed and reach the MoE layer")
        for t in self.saved:
            if t not in CANON_TAGS:
                raise ValueError(
                    f"unknown checkpoint tag {t!r}; known: {CANON_TAGS}")
        norm = tuple(t for t in CANON_TAGS if t in self.saved)
        object.__setattr__(self, "saved", norm)
        for scope, t, d in self.overrides:
            _validate_scope(scope)
            if t not in CANON_TAGS:
                raise ValueError(
                    f"unknown checkpoint tag {t!r}; known: {CANON_TAGS}")
            if d not in _DECISIONS:
                raise ValueError(
                    f"unknown decision {d!r}; known: {_DECISIONS}")
        # Dedupe identical (scope, tag, decision) triples keeping the LAST
        # occurrence: decisions are last-match-wins, so dropping a repeated
        # final directive in favour of its first occurrence would resurrect
        # an intervening opposite decision.
        seen, kept = set(), []
        for item in reversed(self.overrides):
            if item not in seen:
                seen.add(item)
                kept.append(item)
        object.__setattr__(self, "overrides", tuple(reversed(kept)))

    # -- decisions ----------------------------------------------------------

    def decision(self, tag: str, kind: str | None = None) -> str:
        """``save`` | ``recompute`` for a tag (in a block kind's scope)."""
        if self.special == "full":
            dec = SAVE
        elif self.special == "dots":    # matmul outputs are what dots saves
            dec = SAVE if tag in (FFN_A, FFN_B, ATTN_OUT, QKV) else RECOMPUTE
        else:
            dec = SAVE if tag in self.saved else RECOMPUTE
        if kind is not None:
            for scope, t, d in self.overrides:
                if t == tag and scope_matches(scope, kind):
                    dec = d
        return dec

    def override_for(self, tag: str, kinds: tuple[str, ...]) -> str | None:
        """The explicit scoped decision for ``tag`` over any of ``kinds``
        (last matching override wins), or None when the plan leaves it to
        the default scope / the config's alias."""
        dec = None
        for scope, t, d in self.overrides:
            if t == tag and any(scope_matches(scope, k) for k in kinds):
                dec = d
        return dec

    def scoped_saved(self, kind: str) -> tuple[str, ...]:
        """The effective save set for one block kind."""
        return tuple(t for t in CANON_TAGS
                     if self.decision(t, kind) == SAVE)

    # -- rendering ----------------------------------------------------------

    def spec(self) -> str:
        """Canonical spec string; ``parse_plan(p.spec()) == p``."""
        if self.name:
            return self.name
        head = self.special or "save=" + ",".join(self.saved)
        segs = [head]
        segs += [f"{scope}:{d}={t}" for scope, t, d in self.overrides]
        return ";".join(segs)

    def __str__(self) -> str:
        return self.spec()

    # -- estimation + budget fit -------------------------------------------

    def estimate_saved_bytes(self, cfg, n_tokens: int, *,
                             batch: int = 1) -> int | None:
        """Static activation-residual estimate for the whole stack
        (``cfg.num_groups`` groups), from shapes and decisions alone.
        ``batch`` (the sequence count inside ``n_tokens``) only refines the
        SSM_STATE carry-snapshot floor.  Returns ``None`` for the special
        policies (``full``, ``dots``): they are not tag sets."""
        if self.special:
            return None
        total = 0
        for kind, sizes in tag_bytes_by_kind(cfg, n_tokens, batch=batch):
            saved = self.scoped_saved(kind)
            total += sum(sizes[t] for t in kind_tags(kind) if t in saved)
        return cfg.num_groups * total

    @classmethod
    def fit(cls, cfg, n_tokens: int, hbm_budget: int, *, batch: int = 1,
            candidates: list["CheckpointPlan"] | None = None,
            prefer: "CheckpointPlan | None" = None, rank: str = "peak",
            mode: str | None = None, n_model: int = 1, n_node: int = 1,
            base: str = "train") -> "FitResult":
        """Budget-driven selection.

        ``rank="peak"`` (default) walks every candidate through the
        per-phase memory simulator (:mod:`repro_torch.core.memsim`) and
        picks the cheapest-*recompute* plan whose simulated per-device
        peak fits under ``hbm_budget`` bytes.  ``mode``/``n_model``/
        ``n_node`` select the MoE distribution being simulated and
        ``base`` what sits under the activation timeline (the default
        ``"train"``: params + grads + AdamW m/v + activations).

        ``rank="residual"`` ranks by :meth:`estimate_saved_bytes` against
        the budget (blind to transient peaks).

        ``candidates`` defaults to :func:`fit_candidates`.  ``prefer`` is
        tried first and wins whenever it fits.  When nothing fits, the
        lowest-peak (or least-saving) candidate is chosen; the caller can
        read ``fits`` off the table."""
        if rank not in ("peak", "residual"):
            raise ValueError(f"unknown fit rank {rank!r}; peak|residual")
        if rank == "residual":
            return cls._fit_residual(cfg, n_tokens, hbm_budget, batch=batch,
                                     candidates=candidates, prefer=prefer)
        from repro_torch.core import memsim
        if candidates is None:
            candidates = fit_candidates(cfg)

        def sim(p):
            return memsim.simulate(cfg, n_tokens, batch=batch, plan=p,
                                   mode=mode, n_model=n_model,
                                   n_node=n_node, base=base)

        rows = [(p, sim(p)) for p in candidates]
        rows.sort(key=lambda pt: (pt[1].recompute_bytes, pt[1].peak_bytes))
        if prefer is not None:
            rows = [(prefer, sim(prefer))] + \
                [r for r in rows if r[0] != prefer]
        chosen = next((p for p, t in rows if t.peak_bytes <= hbm_budget),
                      None)
        if chosen is None:
            chosen = min(rows, key=lambda pt: pt[1].peak_bytes)[0]
        table = tuple(
            FitRow(spec=p.spec(),
                   est_saved_bytes=p.estimate_saved_bytes(
                       cfg, n_tokens, batch=batch),
                   fits=t.peak_bytes <= hbm_budget, chosen=p == chosen,
                   sim_peak_bytes=t.peak_bytes, peak_phase=t.peak_phase)
            for p, t in rows)
        timeline = next(t for p, t in rows if p == chosen)
        return FitResult(plan=chosen, budget_bytes=int(hbm_budget),
                         table=table, rank="peak", base=base,
                         timeline=timeline)

    @classmethod
    def _fit_residual(cls, cfg, n_tokens: int, hbm_budget: int, *,
                      batch: int = 1, candidates=None,
                      prefer=None) -> "FitResult":
        if candidates is None:
            candidates = [p for p in PLAN_REGISTRY.values() if not p.special]
        rows = [(p, p.estimate_saved_bytes(cfg, n_tokens, batch=batch))
                for p in candidates]
        rows = [(p, e) for p, e in rows if e is not None]
        if not rows:
            raise ValueError("no estimable candidate plans to fit")
        rows.sort(key=lambda pe: -pe[1])
        if prefer is not None:
            e = prefer.estimate_saved_bytes(cfg, n_tokens, batch=batch)
            if e is None:
                raise ValueError(
                    f"preferred plan {prefer.spec()!r} is not statically "
                    "estimable and cannot enter a residual-rank budget fit")
            rows = [(prefer, e)] + [r for r in rows if r[0] != prefer]
        chosen = next((p for p, e in rows if e <= hbm_budget), None)
        if chosen is None:
            chosen = min(rows, key=lambda pe: pe[1])[0]
        table = tuple(
            FitRow(spec=p.spec(), est_saved_bytes=int(e),
                   fits=e <= hbm_budget, chosen=p == chosen)
            for p, e in rows)
        return FitResult(plan=chosen, budget_bytes=int(hbm_budget),
                         table=table, rank="residual")


def fit_candidates(cfg) -> list[CheckpointPlan]:
    """The default candidates of a peak-ranked fit: every registry plan,
    plus, when the block pattern has an MoE kind, ``full``-seeded scoped
    specs that peel the MoE layer's residuals off one step at a time
    (``ffn_yswi`` recomputed, then A and B too, replaying two grouped GEMMs
    in the backward).  Scoped variants of the *wrapped* plans are not
    enumerated: inside a checkpoint region the MoE residuals are transient,
    so those specs simulate identically to their seeds."""
    plans = [PLAN_REGISTRY[n] for n in plan_order()]
    if any(k.endswith("moe") for k in cfg.block_pattern):
        plans += [parse_plan("full;moe:recompute=ffn_yswi"),
                  parse_plan("full;moe:recompute=ffn_a,ffn_b,ffn_yswi")]
    return plans


@dataclass(frozen=True)
class FitRow:
    spec: str
    est_saved_bytes: int | None
    fits: bool
    chosen: bool
    sim_peak_bytes: int | None = None
    peak_phase: str = ""


@dataclass(frozen=True)
class FitResult:
    """Outcome of :meth:`CheckpointPlan.fit`: the chosen plan plus every
    candidate's estimate, simulated peak and fit verdict.  ``timeline`` is
    the chosen plan's simulated timeline (None under ``rank="residual"``)."""

    plan: CheckpointPlan
    budget_bytes: int
    table: tuple[FitRow, ...]
    rank: str = "peak"
    base: str = "train"
    timeline: "object | None" = None

    @property
    def resolved(self) -> "ResolvedPlan":
        return ResolvedPlan(self.plan, "fit")


# ---------------------------------------------------------------------------
# Registry + spec parser
# ---------------------------------------------------------------------------

PLAN_REGISTRY: dict[str, CheckpointPlan] = {
    # Save nothing; recompute the whole layer in backward (max saving).
    "none": CheckpointPlan(name="none"),
    # Paper policy: save the GEMM outputs (A, B, attention projections) and
    # Y_swi (Algorithm 1 line 11); recompute all other elementwise work.
    "paper": CheckpointPlan(
        saved=(FFN_A, FFN_B, FFN_YSWI, ATTN_OUT, QKV), name="paper"),
    # Beyond-paper: also drop Y_swi (recompute SiLU(A)·B in backward).
    "paper_min": CheckpointPlan(
        saved=(FFN_A, FFN_B, ATTN_OUT, QKV), name="paper_min"),
    # Save everything (plain autograd: no checkpoint region).
    "full": CheckpointPlan(name="full", special="full"),
    # Classic: save all matmul outputs.
    "dots": CheckpointPlan(name="dots", special="dots"),
}


def plan_order() -> tuple[str, ...]:
    """Registry plan names ordered by how much they save: tag plans by
    ascending save-set size, then the special policies."""
    tags = sorted((p for p in PLAN_REGISTRY.values() if not p.special),
                  key=lambda p: (len(p.saved), p.name))
    spec = sorted((p for p in PLAN_REGISTRY.values() if p.special),
                  key=lambda p: p.name)
    return tuple(p.name for p in tags + spec)


@lru_cache(maxsize=None)
def parse_plan(spec: str) -> CheckpointPlan:
    """Parse a plan spec (or registry name) to a :class:`CheckpointPlan`.

    Grammar: ``spec := segment (';' segment)*``;
    ``segment := [scope ':'] ('save'|'recompute') '=' tag (',' tag)*``, or a
    bare registry name as a *seed* segment (``"paper;moe:recompute=
    ffn_yswi"`` starts from the paper save set, ``"full;moe:recompute=
    ffn_a,ffn_b"`` keeps save-everything for the stack while shrinking the
    MoE residuals).  Unscoped ``save``/``recompute`` segments build the
    default save set (starting empty: all-recompute); scoped segments
    become per-kind overrides.  Raises ``ValueError`` on anything
    unknown."""
    if not isinstance(spec, str):
        raise ValueError(f"checkpoint plan spec must be a str, got {spec!r}")
    if spec in PLAN_REGISTRY:
        return PLAN_REGISTRY[spec]
    if "=" not in spec and ";" not in spec:
        raise ValueError(
            f"unknown checkpoint plan {spec!r}: not a registered name "
            f"({tuple(PLAN_REGISTRY)}) and not a spec "
            "('[scope:]save|recompute=tag,...' segments joined by ';')")
    saved: list[str] = []
    overrides: list[tuple[str, str, str]] = []
    special = ""
    for seg in spec.split(";"):
        seg = seg.strip()
        if not seg:
            continue
        if "=" not in seg:                      # seed segment: registry name
            if seg not in PLAN_REGISTRY:
                raise ValueError(
                    f"bad plan segment {seg!r}: not a registry name "
                    f"({tuple(PLAN_REGISTRY)}) and not "
                    "'[scope:]save|recompute=tag,...'")
            seed = PLAN_REGISTRY[seg]
            if seed.special:
                special = seed.special
            for t in seed.saved:
                if t not in saved:
                    saved.append(t)
            continue
        head, _, tail = seg.partition("=")
        scope = None
        directive = head.strip()
        if ":" in directive:
            scope, _, directive = directive.partition(":")
            scope = _validate_scope(scope.strip())
            directive = directive.strip()
        if directive not in _DECISIONS:
            raise ValueError(
                f"bad plan segment {seg!r}: directive {directive!r} "
                f"not in {_DECISIONS}")
        tags = [t.strip() for t in tail.split(",") if t.strip()]
        for t in tags:
            if t not in CANON_TAGS:
                raise ValueError(
                    f"bad plan segment {seg!r}: unknown tag {t!r}; "
                    f"known: {CANON_TAGS}")
            if scope is None:
                if directive == SAVE and t not in saved:
                    saved.append(t)
                elif directive == RECOMPUTE and t in saved:
                    saved.remove(t)
            else:
                overrides.append((scope, t, directive))
    return CheckpointPlan(saved=tuple(saved), overrides=tuple(overrides),
                          special=special)


def get_plan(name_or_spec) -> CheckpointPlan:
    """Registry name, spec string, plan, or resolved plan ->
    :class:`CheckpointPlan`."""
    if isinstance(name_or_spec, ResolvedPlan):
        return name_or_spec.plan
    if isinstance(name_or_spec, CheckpointPlan):
        return name_or_spec
    return parse_plan(name_or_spec)


# ---------------------------------------------------------------------------
# Resolution (the precedence of core/gmm_backend.resolve)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ResolvedPlan:
    """A concrete plan with provenance: which precedence slot won (``arg``
    | ``config`` | ``default`` | ``fit``).  ``spec`` is the canonical
    rendering that the train step's history records."""

    plan: CheckpointPlan
    source: str

    @property
    def spec(self) -> str:
        return self.plan.spec()

    def __str__(self) -> str:
        return self.spec


def resolve_plan(policy: "str | CheckpointPlan | ResolvedPlan | None" = None,
                 *, config: "str | None" = None) -> ResolvedPlan:
    """Resolve a checkpoint-plan request: ``policy`` (call-site argument)
    > ``config`` (``ModelConfig.remat_policy``, name or spec) > the
    ``"none"`` default.  A ``ResolvedPlan`` is returned unchanged."""
    if isinstance(policy, ResolvedPlan):
        return policy
    for source, cand in (("arg", policy), ("config", config)):
        if cand is None or cand in ("", "auto"):
            continue
        return ResolvedPlan(get_plan(cand), source)
    return ResolvedPlan(PLAN_REGISTRY["none"], "default")


# ---------------------------------------------------------------------------
# Execution: checkpoint regions from plans
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SavePolicy:
    """What a checkpoint region keeps for its backward (the port's
    counterpart of a ``jax.checkpoint`` policy): the outputs of the
    producers of ``tags`` (:func:`tagged` scopes), or with ``dots`` the
    output of every plain matrix product (``mm``/``addmm``; batched
    products are recomputed, as ``dots_with_no_batch_dims_saveable``
    leaves them).  Empty: keep nothing, recompute everything."""

    tags: tuple[str, ...] = ()
    dots: bool = False


def plan_policies(plan: CheckpointPlan, block_pattern: tuple[str, ...]):
    """How to apply a plan to a group of ``block_pattern`` sublayers.

    Returns ``(mode, payload)``:

      * ``("full", None)``: no checkpoint region at all;
      * ``("group", SavePolicy)``: one region around the whole group,
        chosen whenever no tag is decided differently in two kinds that
        both materialize it (the union tag set is then exactly the
        per-kind decisions);
      * ``("per_kind", {kind: SavePolicy})``: the plan scopes a shared tag
        differently across the kinds of the pattern; each sublayer gets its
        own region with its kind's policy.
    """
    if plan.special == "full":
        return "full", None
    if plan.special == "dots":
        return "group", SavePolicy(dots=True)
    per_kind = {k: tuple(t for t in kind_tags(k)
                         if t in plan.scoped_saved(k))
                for k in dict.fromkeys(block_pattern)}
    decided: dict[str, bool] = {}
    conflict = False
    for k, saved in per_kind.items():
        for t in kind_tags(k):
            d = t in saved
            if decided.setdefault(t, d) != d:
                conflict = True
    if not conflict:
        union = tuple(t for t in CANON_TAGS
                      if any(t in s for s in per_kind.values()))
        return "group", SavePolicy(tags=union)
    return "per_kind", {k: SavePolicy(tags=s) for k, s in per_kind.items()}


_SCOPE = threading.local()


@contextmanager
def tagged(name: str):
    """Mark the op run inside as the producer of tag ``name`` (the
    counterpart of the reference's ``tag(x, name)``).  Keep one op that is
    not a view inside: a region whose policy keeps ``name`` stores that
    op's output.  Outside a checkpoint region it has no effect."""
    prev = getattr(_SCOPE, "name", None)
    _SCOPE.name = name
    try:
        yield
    finally:
        _SCOPE.name = prev


def _policy_fn(policy: SavePolicy):
    from torch.utils.checkpoint import CheckpointPolicy
    dots = {torch.ops.aten.mm.default, torch.ops.aten.addmm.default}

    def fn(ctx, func, *args, **kwargs):
        if policy.dots:
            keep = func in dots
        else:
            keep = (getattr(_SCOPE, "name", None) in policy.tags
                    and not func.is_view)
        return (CheckpointPolicy.MUST_SAVE if keep
                else CheckpointPolicy.PREFER_RECOMPUTE)
    return fn


def checkpoint(fn, *args, policy: SavePolicy):
    """``fn(*args)`` in a non-reentrant checkpoint region that keeps what
    ``policy`` says and recomputes the rest in the backward.  The forward
    draws no random numbers, so the RNG state is not stashed."""
    from torch.utils.checkpoint import checkpoint as _checkpoint
    from torch.utils.checkpoint import create_selective_checkpoint_contexts
    kw = {}
    if policy.tags or policy.dots:
        kw["context_fn"] = partial(create_selective_checkpoint_contexts,
                                   _policy_fn(policy))
    return _checkpoint(fn, *args, use_reentrant=False,
                       preserve_rng_state=False, **kw)


# ---------------------------------------------------------------------------
# MoE residual mode
# ---------------------------------------------------------------------------

#: residual modes of the MoE layer (see core/moe_layer.py):
#:   ab_yswi — save A, B and Y_swi (Algorithm 1 line 11);
#:   ab      — save A, B; recompute Y_swi = SiLU(A)·B in backward;
#:   x       — save neither: recompute A, B (two extra grouped GEMMs) and
#:             Y_swi from the unpermuted input in backward (max saving).
MOE_RESIDUAL_MODES = ("ab_yswi", "ab", "x")


def moe_residual_mode(cfg) -> str:
    """The MoE layer's residual set under ``cfg``'s resolved plan.

    Only *explicit* ``moe``-scoped decisions override ``cfg.save_yswi``:
    the default (unscoped) save set governs the checkpoint regions, never
    the hand-written backward.  FFN_A/FFN_B are coupled residuals (both
    sides of the SwiGLU first layer); deciding them apart raises."""
    plan = resolve_plan(config=cfg.remat_policy).plan
    oa = plan.override_for(FFN_A, MOE_SCOPE_KINDS)
    ob = plan.override_for(FFN_B, MOE_SCOPE_KINDS)
    oy = plan.override_for(FFN_YSWI, MOE_SCOPE_KINDS)
    if oa != ob:
        raise ValueError(
            "FFN_A and FFN_B are coupled residuals in the MoE custom VJP; "
            f"plan {plan.spec()!r} decides them apart "
            f"(ffn_a={oa}, ffn_b={ob})")
    save_ab = oa != RECOMPUTE                   # default: save (paper)
    save_y = cfg.save_yswi if oy is None else oy == SAVE
    if not save_ab:
        if oy == SAVE:
            raise ValueError(
                "FFN_YSWI cannot be saved while FFN_A/FFN_B are recomputed "
                f"in the MoE scope (plan {plan.spec()!r}): the backward "
                "needs A and B regardless, so saving Y_swi is pure waste")
        return "x"
    return "ab_yswi" if save_y else "ab"


# ---------------------------------------------------------------------------
# Static byte accounting
# ---------------------------------------------------------------------------

#: chunk sizes of the reference's recurrent scans (models/ssm.py): one f32
#: carry snapshot survives per chunk.
_SSM_SCAN_CHUNK = {"mlstm": 256, "slstm": 1024, "hymba": 256}

_ITEMSIZE = {"float32": 4, "bfloat16": 2, "float16": 2, "float64": 8}


def _ssm_state_bytes(cfg, kind: str, n_tokens: int, batch: int = 1) -> int:
    """SSM_STATE bytes per group: the per-chunk carry snapshots of the
    recurrent scans (always f32).  The scans clamp ``chunk = min(chunk,
    S)``, so even a sub-chunk sequence holds one carry per batch row."""
    snaps = max(n_tokens // _SSM_SCAN_CHUNK[kind], batch, 1)
    if kind == "mlstm":
        H = cfg.num_heads
        dhh = 2 * cfg.d_model // H
        elems = H * (dhh * dhh + dhh + 1)       # C (D,D) + n (D,) + m ()
    elif kind == "slstm":
        elems = 3 * cfg.d_model                 # c, n, m
    else:                                       # hymba mamba heads
        elems = cfg.ssm_heads * cfg.resolved_head_dim * cfg.ssm_state
    return snaps * elems * 4


def tag_bytes_by_kind(cfg, n_tokens: int, *,
                      batch: int = 1) -> tuple[tuple[str, dict], ...]:
    """Bytes of each tagged tensor per block-pattern slot, from shapes.

    One ``(kind, {tag: bytes})`` per entry of ``cfg.block_pattern``: the q
    projection (QKV), the attention output projection (ATTN_OUT), the
    dense FFN's products and SwiGLU product (FFN_A/B/YSWI; the MoE expert
    FFN manages its residuals in its own backward), the router top-k
    weights (MOE_GATES), and the recurrent-scan carry snapshots
    (SSM_STATE) of the reference's ssm and hybrid kinds."""
    item = _ITEMSIZE[cfg.dtype]
    out = []
    for kind in cfg.block_pattern:
        sizes = dict.fromkeys(CANON_TAGS, 0)
        has_attn = "attn" in kind or kind == "hymba"
        if has_attn:
            sizes[QKV] = n_tokens * cfg.num_heads * cfg.resolved_head_dim
            sizes[ATTN_OUT] = n_tokens * cfg.d_model
        if kind.endswith("moe"):
            sizes[MOE_GATES] = n_tokens * cfg.top_k
        elif has_attn:                          # dense FFN sublayer
            n = 3 if cfg.ffn_act == "swiglu" else 1
            for t in (FFN_A, FFN_B, FFN_YSWI)[:n]:
                sizes[t] = n_tokens * cfg.d_ff
        sizes = {t: b * item for t, b in sizes.items()}
        if kind in _SSM_SCAN_CHUNK:
            sizes[SSM_STATE] = _ssm_state_bytes(cfg, kind, n_tokens, batch)
        out.append((kind, sizes))
    return tuple(out)


def tag_bytes_per_group(cfg, n_tokens: int, *, batch: int = 1) -> dict:
    """Summed-over-pattern view of :func:`tag_bytes_by_kind`."""
    totals = dict.fromkeys(CANON_TAGS, 0)
    for _, sizes in tag_bytes_by_kind(cfg, n_tokens, batch=batch):
        for t, b in sizes.items():
            totals[t] += b
    return totals


def estimate_saved_bytes(cfg, policy, n_tokens: int, *,
                         batch: int = 1) -> int | None:
    """Static activation-residual estimate for a plan (name, spec, or
    object), whole stack; ``None`` for ``full`` and ``dots``."""
    return resolve_plan(policy).plan.estimate_saved_bytes(cfg, n_tokens,
                                                          batch=batch)


def parse_size(s: "str | int | float") -> int:
    """Parse a byte size: plain numbers or ``KiB/MiB/GiB/KB/MB/GB``
    suffixes (``"3.5GiB"``)."""
    if isinstance(s, (int, float)):
        return int(s)
    t = s.strip().lower()
    units = {"kib": 2**10, "mib": 2**20, "gib": 2**30,
             "kb": 1e3, "mb": 1e6, "gb": 1e9, "b": 1}
    for suf, mul in units.items():
        if t.endswith(suf):
            return int(float(t[:-len(suf)]) * mul)
    return int(float(t))
