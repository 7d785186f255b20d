"""Port parity: activation-checkpoint plans (``core/checkpoint.py``) and
their application in the training forward.

- The plan arithmetic equals the reference's exactly: spec parsing and
  rendering, bad specs, ``moe_residual_mode`` (with its raises),
  ``plan_policies``' modes and tag sets, the byte accounting and
  ``estimate_saved_bytes``, the budget fit's tables over a budget ladder
  (spec, estimate, simulated peak, fit, choice), resolution.
- Gradients of ``train_loss`` under every registry plan against
  ``jax.grad`` under the same plan, on the reference memory bench's dense
  and MoE configs (float32, batch 2 x 32), at the reference's own 1e-5
  (``tests/test_checkpoint_policy.py``), and the per-kind application on
  an alternating local/global pattern.
- What the plans change: the bytes the graph holds for the backward
  (``compat.saved_residual_nbytes``) strictly ordered none < paper_min <
  paper < full (dense) and none < paper < full (MoE), the MoE residual
  modes x < ab < ab_yswi under ``full``, and ``estimate_saved_bytes``
  within 0.3 relative of the measured growth over ``none``, as the
  reference holds its own (``tests/test_checkpoint_policy.py:79-97``);
  the forward-plus-recompute FLOPs (``FlopCounterMode``) ordered full <
  paper < none, which shows that a saved tag's producer is not run again.
- ``make_train_step``'s ``resolved_plan`` and ``peak_sim_bytes`` equal the
  reference's; a 3-step trajectory under ``paper`` against the
  reference's ``make_train_step(remat_policy="paper")`` at the tolerances
  of ``tests/test_torch_train.py``; ``train`` records the plan; the
  engine and ``blaze_pallas`` refuse what they cannot honour.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.bench.memory import bench_config, bench_dense_config
from repro.configs import get_config
from repro.configs.base import TrainConfig as JTrainConfig
from repro.core import checkpoint as JCK
from repro.data.pipeline import make_batch_iterator as j_batches
from repro.models import transformer as JT
from repro.train.loop import make_train_step as j_make_train_step
from repro.train.optimizer import init_adamw as j_init_adamw
from torch_parity import f32, np_params, to_torch, torch_config
from torch_parity import tp  # noqa: F401

DENSE = bench_dense_config()
MOE = bench_config().replace(gmm_backend="segment")
LOCAL = DENSE.replace(block_pattern=("attn_local_ffn", "attn_ffn"),
                      local_global_period=2, num_layers=2, sliding_window=16)
REGISTRY = ("none", "paper_min", "paper", "dots", "full")
BATCH, SEQ = 2, 32

SPECS = (
    "none", "paper", "paper_min", "full", "dots",
    "save=ffn_a,ffn_b,qkv",
    "save=ffn_a,ffn_b,qkv;moe:recompute=ffn_yswi",
    "save=qkv,attn_out;attn_local_ffn:recompute=qkv",
    "moe:recompute=ffn_a,ffn_b",
    "moe:recompute=ffn_a",
    "moe:recompute=ffn_a,ffn_b;moe:save=ffn_yswi",
    "moe:save=ffn_yswi;moe:recompute=ffn_yswi;moe:save=ffn_yswi",
    "moe:recompute=ffn_yswi",
    "save=",
    "paper;moe:recompute=ffn_yswi",
    "full;moe:recompute=ffn_a,ffn_b",
    "full;moe:recompute=ffn_a,ffn_b,ffn_yswi",
    "save=qkv,ffn_a,ffn_a",
    "save=ffn_a,qkv;recompute=qkv",
    "save=ssm_state;ssm:recompute=ssm_state",
    "*moe:recompute=ffn_a,ffn_b;attn:save=qkv",
)
BAD_SPECS = ("bogus", "save=bogus_tag", "bogus_scope:save=qkv",
             "zzz*:save=qkv", "moe:keep=qkv", "paper;save=qkv;full")


def _port():
    from repro_torch.core import checkpoint as CK
    return CK


def _plan_fields(p):
    return (p.saved, p.overrides, p.name, p.special, p.spec())


# ---------------------------------------------------------------------------
# plan arithmetic: equal to the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec", SPECS)
def test_spec_matches_reference(spec):
    CK = _port()
    p, r = CK.parse_plan(spec), JCK.parse_plan(spec)
    assert _plan_fields(p) == _plan_fields(r)
    assert CK.parse_plan(p.spec()) == p
    for kind in JCK.BLOCK_KINDS:
        assert p.scoped_saved(kind) == r.scoped_saved(kind), kind


@pytest.mark.parametrize("spec", BAD_SPECS + (123,))
def test_bad_specs_raise_as_in_reference(spec):
    CK = _port()
    with pytest.raises((ValueError, TypeError)):
        JCK.get_plan(spec)
    with pytest.raises((ValueError, TypeError)):
        CK.get_plan(spec)


def _outcome(fn):
    try:
        return fn()
    except ValueError as e:
        return ("raises", str(e))


def test_moe_residual_mode_matches_reference():
    CK = _port()
    n_raise = 0
    for spec in SPECS:
        for save_yswi in (True, False):
            jcfg = MOE.replace(remat_policy=spec, save_yswi=save_yswi)
            want = _outcome(lambda: JCK.moe_residual_mode(jcfg))
            got = _outcome(lambda: CK.moe_residual_mode(torch_config(jcfg)))
            assert got == want, (spec, save_yswi)
            n_raise += isinstance(want, tuple)
            if not isinstance(want, tuple):
                assert torch_config(jcfg).resolved_save_yswi == \
                    jcfg.resolved_save_yswi
    assert n_raise >= 4       # both raises, under both aliases


def test_plan_policies_match_reference():
    CK = _port()
    patterns = (("attn_ffn",), ("attn_moe",), ("attn_local_ffn", "attn_ffn"),
                ("attn_ffn", "attn_moe"), ("attn_local_moe",))
    modes = set()
    for spec in SPECS:
        for pat in patterns:
            mode, payload = CK.plan_policies(CK.parse_plan(spec), pat)
            jmode, jpayload = JCK.plan_policies(JCK.parse_plan(spec), pat)
            assert mode == jmode, (spec, pat)
            modes.add(mode)
            r = JCK.parse_plan(spec)
            want = {k: tuple(t for t in JCK.kind_tags(k)
                             if t in r.scoped_saved(k))
                    for k in dict.fromkeys(pat)}
            if mode == "per_kind":
                assert set(payload) == set(jpayload)
                assert {k: v.tags for k, v in payload.items()} == want
            elif mode == "group" and r.special == "dots":
                assert payload == CK.SavePolicy(dots=True)
            elif mode == "group":
                union = tuple(t for t in JCK.CANON_TAGS
                              if any(t in s for s in want.values()))
                assert payload == CK.SavePolicy(tags=union)
            else:
                assert payload is None
    assert modes == {"full", "group", "per_kind"}


def test_byte_accounting_matches_reference():
    CK = _port()
    cfgs = (DENSE, MOE, LOCAL, get_config("mixtral_8x7b"),
            get_config("qwen3_14b"), get_config("paper_conf3"),
            get_config("hymba_1_5b").reduced(),
            get_config("xlstm_1_3b").reduced())
    for jcfg in cfgs:
        tcfg = torch_config(jcfg)
        for n_tokens, batch in ((64, 2), (256, 4), (4096, 1)):
            assert CK.tag_bytes_by_kind(tcfg, n_tokens, batch=batch) == \
                JCK.tag_bytes_by_kind(jcfg, n_tokens, batch=batch)
            assert CK.tag_bytes_per_group(tcfg, n_tokens, batch=batch) == \
                JCK.tag_bytes_per_group(jcfg, n_tokens, batch=batch)
            for spec in SPECS:
                if isinstance(_outcome(lambda: JCK.parse_plan(spec)), tuple):
                    continue
                assert CK.estimate_saved_bytes(
                    tcfg, spec, n_tokens, batch=batch) == \
                    JCK.estimate_saved_bytes(jcfg, spec, n_tokens,
                                             batch=batch), (jcfg.name, spec)


def _table(fit):
    return ([dataclasses.astuple(r) for r in fit.table], fit.plan.spec(),
            fit.budget_bytes, fit.rank, fit.base)


@pytest.mark.parametrize("name", ["dense", "moe", "mixtral"])
def test_fit_tables_match_reference(name):
    """Every candidate's estimate, simulated peak, peak phase, fit verdict
    and the choice, over a ladder of budgets that falls between each pair
    of candidates' simulated peaks (peak rank) and estimates (residual
    rank), with and without a preferred plan."""
    CK = _port()
    jcfg = {"dense": DENSE, "moe": MOE,
            "mixtral": get_config("mixtral_8x7b")}[name]
    tcfg = torch_config(jcfg)
    n = 64 if name != "mixtral" else 4096
    peaks = sorted({r.sim_peak_bytes for r in
                    JCK.CheckpointPlan.fit(jcfg, n, 0).table})
    ladder = [0] + [p + 1 for p in peaks] + [(a + b) // 2 for a, b in
                                             zip(peaks, peaks[1:])]
    chosen = set()
    for budget in ladder:
        for prefer in (None, "paper_min"):
            want = JCK.CheckpointPlan.fit(
                jcfg, n, budget, batch=2,
                prefer=prefer and JCK.get_plan(prefer))
            got = CK.CheckpointPlan.fit(
                tcfg, n, budget, batch=2,
                prefer=prefer and CK.get_plan(prefer))
            assert _table(got) == _table(want), (budget, prefer)
            chosen.add(want.plan.spec())
            want = JCK.CheckpointPlan.fit(jcfg, n, budget, rank="residual")
            got = CK.CheckpointPlan.fit(tcfg, n, budget, rank="residual")
            assert _table(got) == _table(want), budget
    assert len(chosen) >= (2 if name == "mixtral" else 3), chosen


def test_resolution_and_sizes_match_reference():
    CK = _port()
    for policy, config in (("paper", "none"), (None, "paper_min"),
                           (None, None), ("", "auto"), (None, "dots")):
        got = CK.resolve_plan(policy, config=config)
        want = JCK.resolve_plan(policy, config=config)
        assert (got.spec, got.source) == (want.spec, want.source)
    r = CK.resolve_plan(None)
    assert CK.resolve_plan(r) is r
    assert CK.plan_order() == JCK.plan_order()
    for s in ("2GiB", "1.5MiB", "1000", 4096, "3.5gb", "12KB"):
        assert CK.parse_size(s) == JCK.parse_size(s)
    with pytest.raises(ValueError):
        CK.parse_size("2 buckets")


# ---------------------------------------------------------------------------
# the plans in the training forward
# ---------------------------------------------------------------------------


def _batch(jcfg, seed=1):
    toks = np.random.default_rng(seed).integers(
        0, jcfg.vocab_size, size=(BATCH, SEQ)).astype(np.int32)
    return {"tokens": toks, "labels": toks}


@pytest.fixture(scope="module")
def jparams():
    return {n: JT.init_params(jax.random.PRNGKey(0), c)
            for n, c in (("dense", DENSE), ("moe", MOE), ("local", LOCAL))}


def _port_params(tp, jcfg, jp):
    from repro_torch.train.optimizer import tree_leaves
    params = tp.interop.params_from_jax(np_params(jp), torch_config(jcfg),
                                        device="cpu", dtype=tp.torch.float32)
    for p in tree_leaves(params):
        p.requires_grad_(True)
    return params


def _port_grads(tp, params, batch, tcfg):
    from repro_torch.train.optimizer import tree_leaves
    loss, _ = tp.transformer.train_loss(
        params, {k: to_torch(v) for k, v in batch.items()}, tcfg)
    return loss, tp.torch.autograd.grad(loss, tree_leaves(params))


@pytest.mark.parametrize("plan", REGISTRY)
@pytest.mark.parametrize("name", ["dense", "moe"])
def test_grads_under_plan_match_reference(tp, jparams, name, plan):
    """``train_loss`` gradients under ``plan`` against ``jax.grad`` of the
    reference's under the same plan: 1e-5 absolute (the reference's own
    tolerance between its plans) over 1e-5 relative."""
    from repro_torch.train.optimizer import tree_leaves
    jcfg = {"dense": DENSE, "moe": MOE}[name].replace(remat_policy=plan)
    batch = _batch(jcfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    loss_ref, grads_ref = jax.jit(jax.value_and_grad(
        lambda p: JT.train_loss(p, jb, jcfg)[0]))(jparams[name])
    params = _port_params(tp, jcfg, jparams[name])
    loss, grads = _port_grads(tp, params, batch, torch_config(jcfg))
    np.testing.assert_allclose(float(loss.detach()), float(loss_ref),
                               rtol=1e-5)
    want = tree_leaves(tp.interop.params_from_jax(
        np_params(grads_ref), torch_config(jcfg), device="cpu",
        dtype=tp.torch.float32))
    for i, (g, w) in enumerate(zip(grads, want)):
        np.testing.assert_allclose(f32(g), f32(w), rtol=1e-5, atol=1e-5,
                                   err_msg=f"{plan}: leaf {i}")


def test_per_kind_plan_grads_match_reference(tp, jparams):
    """A plan that decides QKV differently in the local and the global
    kind wraps each sublayer on its own (``per_kind``); its gradients match
    the reference's under the same plan and the port's under ``full``."""
    spec = "save=qkv,attn_out;attn_local_ffn:recompute=qkv"
    jcfg = LOCAL.replace(remat_policy=spec)
    assert JCK.plan_policies(JCK.parse_plan(spec),
                             LOCAL.block_pattern)[0] == "per_kind"
    batch = _batch(jcfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    grads_ref = jax.jit(jax.grad(
        lambda p: JT.train_loss(p, jb, jcfg)[0]))(jparams["local"])
    from repro_torch.train.optimizer import tree_leaves
    params = _port_params(tp, jcfg, jparams["local"])
    _, grads = _port_grads(tp, params, batch, torch_config(jcfg))
    _, grads_full = _port_grads(tp, params, batch,
                                torch_config(LOCAL.replace(
                                    remat_policy="full")))
    want = tree_leaves(tp.interop.params_from_jax(
        np_params(grads_ref), torch_config(jcfg), device="cpu",
        dtype=tp.torch.float32))
    for i, (g, gf, w) in enumerate(zip(grads, grads_full, want)):
        np.testing.assert_allclose(f32(g), f32(w), rtol=1e-5, atol=1e-5,
                                   err_msg=f"leaf {i}")
        np.testing.assert_allclose(f32(g), f32(gf), rtol=1e-5, atol=1e-5,
                                   err_msg=f"leaf {i} against full")


def _held(tp, jcfg, jp, plan):
    from repro_torch.compat import saved_residual_nbytes
    tcfg = torch_config(jcfg).replace(remat_policy=plan)
    params = _port_params(tp, jcfg, jp)
    batch = {k: to_torch(v) for k, v in _batch(jcfg).items()}
    return saved_residual_nbytes(tp.transformer.train_loss, params, batch,
                                 tcfg)


def test_held_bytes_ordered_and_estimated(tp, jparams):
    """The bytes the graph holds for the backward: none < paper_min <
    paper < full on the dense stack, dots < full; the static estimate
    within 0.3 of each tag plan's growth over ``none``."""
    CK = _port()
    b = {plan: _held(tp, DENSE, jparams["dense"], plan) for plan in REGISTRY}
    assert b["none"] < b["paper_min"] < b["paper"] < b["full"], b
    assert b["dots"] < b["full"], b
    n_tokens = BATCH * SEQ
    tcfg = torch_config(DENSE)
    for plan in ("paper_min", "paper"):
        est = CK.estimate_saved_bytes(tcfg, plan, n_tokens)
        assert est > 0
        np.testing.assert_allclose(est, b[plan] - b["none"], rtol=0.3,
                                   err_msg=plan)
    assert CK.estimate_saved_bytes(tcfg, "none", n_tokens) == 0
    assert CK.estimate_saved_bytes(tcfg, "full", n_tokens) is None


def test_held_bytes_moe_plans_and_residual_modes(tp, jparams):
    """On the MoE stack: none < paper < full; under ``full`` the moe-scoped
    residual modes shrink what is held, x < ab < ab_yswi; inside a
    checkpoint region the MoE residuals are transient, so a moe-scoped
    spec seeded from ``none`` holds what ``none`` holds."""
    b = {plan: _held(tp, MOE, jparams["moe"], plan)
         for plan in ("none", "paper", "full", "moe:recompute=ffn_yswi",
                      "full;moe:recompute=ffn_yswi",
                      "full;moe:recompute=ffn_a,ffn_b,ffn_yswi")}
    assert b["none"] < b["paper"] < b["full"], b
    assert (b["full;moe:recompute=ffn_a,ffn_b,ffn_yswi"]
            < b["full;moe:recompute=ffn_yswi"] < b["full"]), b
    assert b["moe:recompute=ffn_yswi"] == b["none"], b


@pytest.mark.parametrize("name", ["dense", "moe"])
def test_recompute_flops_ordered(tp, jparams, name):
    """Forward plus backward FLOPs (``FlopCounterMode``): the gradients'
    own FLOPs are the same under every plan, so the order is the
    recompute's: full (none) < paper (the saved GEMMs skipped) < none
    (the whole forward again)."""
    from torch.utils.flop_counter import FlopCounterMode
    jcfg = {"dense": DENSE, "moe": MOE}[name]
    params = _port_params(tp, jcfg, jparams[name])
    batch = _batch(jcfg)
    flops = {}
    for plan in ("full", "paper", "none"):
        with FlopCounterMode(display=False) as fc:
            _port_grads(tp, params, batch,
                        torch_config(jcfg).replace(remat_policy=plan))
        flops[plan] = fc.get_total_flops()
    assert flops["full"] < flops["paper"] < flops["none"], flops


def test_blaze_pallas_refuses_moe_scoped_residual_plans(tp, jparams):
    """The kernel composition keeps a fixed residual set: a plan whose
    moe-scoped decisions ask for another one raises, as in the
    reference."""
    jcfg = MOE.replace(moe_impl="blaze_pallas")
    params = _port_params(tp, jcfg, jparams["moe"])
    for spec in ("moe:recompute=ffn_a,ffn_b", "full;moe:recompute=ffn_yswi"):
        with pytest.raises(ValueError, match="blaze_pallas"):
            _port_grads(tp, params, _batch(jcfg),
                        torch_config(jcfg.replace(remat_policy=spec)))
    with pytest.raises(ValueError, match="coupled"):
        _port_grads(tp, params, _batch(jcfg), torch_config(
            jcfg.replace(remat_policy="moe:recompute=ffn_a")))


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------


def _tcfgs(**kw):
    from repro_torch.configs import TrainConfig
    jt = JTrainConfig(batch_size=BATCH, seq_len=SEQ, log_every=1, **kw)
    fields = {f.name for f in dataclasses.fields(TrainConfig)}
    return jt, TrainConfig(**{k: v for k, v in dataclasses.asdict(jt).items()
                              if k in fields})


def test_train_step_plan_and_peak_match_reference():
    """``resolved_plan`` (spec and provenance) and ``peak_sim_bytes`` of
    ``make_train_step`` equal the reference's: the config's plan, a
    call-site plan, and budget fits with and without a preferred plan."""
    from repro_torch.train.loop import make_train_step
    jt, tt = _tcfgs(total_steps=1)
    cases = [(DENSE, {}), (DENSE.replace(remat_policy="paper"), {}),
             (MOE, dict(remat_policy="dots")),
             (DENSE, dict(hbm_budget=2_220_000)),
             (MOE, dict(hbm_budget=1_000_000)),
             (MOE, dict(hbm_budget=10**9, remat_policy="paper")),
             (MOE.replace(remat_policy="full;moe:recompute=ffn_yswi"), {})]
    specs = set()
    for jcfg, kw in cases:
        want = j_make_train_step(jcfg, jt, **kw)
        got = make_train_step(torch_config(jcfg), tt, "cpu", **kw)
        assert (got.resolved_plan.spec, got.resolved_plan.source) == \
            (want.resolved_plan.spec, want.resolved_plan.source), kw
        assert got.peak_sim_bytes == want.peak_sim_bytes, kw
        specs.add(got.resolved_plan.spec)
    assert len(specs) >= 5


def test_paper_trajectory_matches_reference(tp, jparams):
    """Three steps of the MoE stack under ``paper`` (``remat_policy`` at
    the call site) against the reference's ``make_train_step(
    remat_policy="paper")`` on the same pipeline batches, held as
    ``tests/test_torch_train.py`` holds the default plan: losses to 1e-4;
    every parameter within the sum of the step sizes and all but a 1e-4
    share of each leaf within 2e-3 lr."""
    from repro_torch.train.loop import make_train_step
    from repro_torch.train.optimizer import init_adamw, tree_leaves
    jt, tt = _tcfgs(learning_rate=1e-3, warmup_steps=1, total_steps=3)
    batches = [b for b, _ in zip(j_batches(MOE.vocab_size, SEQ, BATCH,
                                           jt.seed), range(3))]
    step = jax.jit(j_make_train_step(MOE, jt, remat_policy="paper"))
    jp, jopt = jparams["moe"], j_init_adamw(jparams["moe"])
    losses_ref = []
    for b in batches:
        jp, jopt, m = step(jp, jopt, {k: jnp.asarray(v)
                                      for k, v in b.items()})
        losses_ref.append(float(m["loss"]))
    tstep = make_train_step(torch_config(MOE), tt, "cpu",
                            remat_policy="paper")
    assert tstep.resolved_plan.spec == "paper"
    params = _port_params(tp, MOE, jparams["moe"])
    for p in tree_leaves(params):
        p.requires_grad_(False)
    opt = init_adamw(params)
    losses, lrs = [], []
    for b in batches:
        params, opt, m = tstep(params, opt, b)
        losses.append(float(m["loss"]))
        lrs.append(m["lr"])
    np.testing.assert_allclose(losses, losses_ref, rtol=1e-4)
    lr_sum = sum(lrs)
    for i, (got, want) in enumerate(zip(
            tree_leaves(params), tree_leaves(_port_params(tp, MOE, jp)))):
        err = np.abs(f32(got) - f32(want))
        assert err.max() <= lr_sum, (i, err.max())
        assert int((err > 2e-3 * jt.learning_rate).sum()) <= 1e-4 * err.size


def test_train_records_plan_and_peak(tp):
    """``train`` stamps every step's metrics and history with the plan's
    spec and the simulated peak, as the reference's does."""
    from repro_torch.train.loop import make_train_step, train
    _, tt = _tcfgs(total_steps=2)
    spec = "save=ffn_a,ffn_b,ffn_yswi,attn_out,qkv"
    cfg = torch_config(DENSE).replace(remat_policy=spec)
    hooked = []
    _, _, hist = train(cfg, tt, device="cpu", log=lambda *_: None,
                       step_hook=lambda s, m: hooked.append(
                           (m["remat_plan"], m["peak_sim_bytes"])))
    peak = make_train_step(cfg, tt, "cpu").peak_sim_bytes
    assert hooked == [(spec, peak)] * 2
    assert [(h["remat_plan"], h["peak_sim_bytes"]) for h in hist] == \
        [(spec, peak)] * 2
    assert all(np.isfinite(h["loss"]) for h in hist)


def test_engine_validates_plan_at_construction(tp):
    from repro_torch.interop import init_params
    cfg = torch_config(MOE)
    params = init_params(cfg, tp.torch.Generator().manual_seed(0), "cpu")
    for bad in (dict(remat_policy="save=bogus"),
                dict(remat_policy="moe:recompute=ffn_a")):
        with pytest.raises(ValueError):
            tp.engine.ServeEngine(cfg, params, device="cpu", **bad)
    eng = tp.engine.ServeEngine(cfg, params, device="cpu",
                                remat_policy="paper")
    assert (eng.remat_plan.spec, eng.remat_plan.source) == ("paper", "arg")
