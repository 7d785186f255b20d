"""Port parity: Qwen3-30B-A3B (128 experts, top-8, expert width 768, GQA
32/4 heads of 128 with qk-norm inside a MoE block).

- The port's config converts from the reference's field for field, and
  so does its ``reduced()``; its byte estimates, simulated peaks and the
  budget fit at full width equal the reference's (``num_heads *
  head_dim`` = 4096 differs from ``d_model`` = 2048, which sizes QKV
  apart from ATTN_OUT).
- ``train_loss`` and its gradients against ``jax.value_and_grad`` of the
  reference's (``moe_impl="blaze"`` on ``segment``, ``use_pallas=True``:
  its flash attention in interpret mode), the port on ``blaze_pallas``
  and on ``blaze`` over ``pallas_fused`` (the kernels' plain versions
  here), on the reduced config and on a variant that keeps the model's
  shape where ``reduced()`` cuts it: top-8 of 16 experts and a GQA group
  of 8 with ``num_heads * head_dim`` twice ``d_model``.
- A 3-step float32 run of the port's ``train`` against the reference's
  ``make_train_step`` on the same pipeline batches.
- Prefill and decode logits over float32 pages, and the engine's
  greedy tokens against the reference model's own greedy decode.

Tolerances: those of ``tests/test_torch_train.py`` and
``tests/test_torch_serve.py`` (loss 1e-5, gradients 1e-4 relative over a
floor of 1e-4 of each leaf's scale; losses of the trajectory 1e-4 and its
parameters within the sum of the step sizes, all but 1e-4 of each leaf's
elements within 2e-3 of the learning rate; logits 1e-4).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config
from repro.configs.base import TrainConfig as JTrainConfig
from repro.core import checkpoint as JCK
from repro.data.pipeline import make_batch_iterator as j_batches
from repro.models import transformer as JT
from repro.train.loop import make_train_step as j_make_train_step
from repro.train.optimizer import init_adamw as j_init_adamw
from torch_parity import f32, np_params, to_torch, torch_config
from torch_parity import tp  # noqa: F401

FULL = get_config("qwen3_moe_30b_a3b")
JCFG = FULL.reduced().replace(moe_impl="blaze", gmm_backend="segment",
                              use_pallas=True)
# the model's routing width and GQA group at a reduced size
JCFG_WIDE = JCFG.replace(num_experts=16, top_k=8, num_heads=8,
                         num_kv_heads=1)
PORT_IMPLS = {"blaze_pallas": dict(moe_impl="blaze_pallas"),
              "blaze_pallas_fused": dict(gmm_backend="pallas_fused")}
BATCH, SEQ = 2, 64


def test_config_converts_field_for_field():
    from repro_torch.configs import ARCH_IDS
    from repro_torch.configs import get_config as t_get_config
    assert "qwen3_moe_30b_a3b" in ARCH_IDS
    for name in ("qwen3-moe-30b-a3b", "qwen3_moe_30b_a3b"):
        port = t_get_config(name)
        assert dataclasses.asdict(port) == dataclasses.asdict(FULL)
        assert dataclasses.asdict(port.reduced()) == \
            dataclasses.asdict(FULL.reduced())
    assert FULL.num_heads * FULL.resolved_head_dim != FULL.d_model
    assert JCFG_WIDE.num_heads * JCFG_WIDE.resolved_head_dim == \
        2 * JCFG_WIDE.d_model


def test_byte_accounting_and_fit_match_reference():
    from repro_torch.core import checkpoint as CK
    from repro_torch.core import memsim as MS
    from repro.core import memsim as JMS
    cfg = torch_config(FULL.replace(num_layers=4))
    jcfg = FULL.replace(num_layers=4)
    n = 2 * 2048
    for spec in ("none", "paper_min", "paper", "full"):
        assert CK.estimate_saved_bytes(cfg, spec, n, batch=2) == \
            JCK.estimate_saved_bytes(jcfg, spec, n, batch=2), spec
        plan = CK.get_plan(spec)
        assert MS.simulate_peak(cfg, n, batch=2, plan=plan, mode="single",
                                base="train") == \
            JMS.simulate_peak(jcfg, n, batch=2, plan=JCK.get_plan(spec),
                              mode="single", base="train"), spec
    peaks = sorted({r.sim_peak_bytes for r in
                    JCK.CheckpointPlan.fit(jcfg, n, 0, batch=2).table})
    for budget in [0] + [p + 1 for p in peaks]:
        want = JCK.CheckpointPlan.fit(jcfg, n, budget, batch=2)
        got = CK.CheckpointPlan.fit(cfg, n, budget, batch=2)
        assert [dataclasses.astuple(r) for r in got.table] == \
            [dataclasses.astuple(r) for r in want.table], budget
        assert got.plan.spec() == want.plan.spec(), budget


def _port_params(tp, jp, cfg):
    return tp.interop.params_from_jax(np_params(jp), cfg, device="cpu",
                                      dtype=tp.torch.float32)


@pytest.mark.parametrize("impl", list(PORT_IMPLS))
@pytest.mark.parametrize("jcfg", [JCFG, JCFG_WIDE],
                         ids=["reduced", "top8_gqa8"])
def test_train_loss_and_grads_match_reference(tp, jcfg, impl):
    from repro_torch.train.optimizer import tree_leaves
    cfg = torch_config(jcfg).replace(**PORT_IMPLS[impl])
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    batch = next(j_batches(jcfg.vocab_size, SEQ, BATCH, seed=0))
    (loss_ref, met_ref), grads_ref = jax.jit(jax.value_and_grad(
        lambda p, b: JT.train_loss(p, b, jcfg), has_aux=True))(
            jp, {k: jnp.asarray(v) for k, v in batch.items()})
    params = _port_params(tp, jp, cfg)
    attn = params["layers"][0]["attn"]
    H, dh = jcfg.num_heads, jcfg.resolved_head_dim
    assert tuple(attn["wo"].shape) == (H * dh, jcfg.d_model)
    assert tuple(attn["q_norm"].shape) == (dh,)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, met = tp.transformer.train_loss(
        params, {k: to_torch(v) for k, v in batch.items()}, cfg)
    grads = tp.torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(loss_ref),
                               rtol=1e-5)
    np.testing.assert_allclose(float(met["aux"].detach()),
                               float(met_ref["aux"]), rtol=1e-4)
    want_tree = tree_leaves(_port_params(tp, grads_ref, cfg))
    assert len(want_tree) == len(grads)
    for i, (got, want) in enumerate(zip(grads, want_tree)):
        want = f32(want)
        np.testing.assert_allclose(f32(got), want, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(want).max()),
                                   err_msg=f"leaf {i}")


@pytest.mark.parametrize("impl", list(PORT_IMPLS))
def test_three_step_trajectory_matches_reference(tp, impl):
    from repro_torch.configs import TrainConfig
    from repro_torch.train.loop import train
    from repro_torch.train.optimizer import tree_leaves
    cfg = torch_config(JCFG).replace(**PORT_IMPLS[impl])
    jt = JTrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=3,
                      batch_size=BATCH, seq_len=SEQ, log_every=1)
    jparams = JT.init_params(jax.random.PRNGKey(0), JCFG)
    step = jax.jit(j_make_train_step(JCFG, jt))
    jp, jopt = jparams, j_init_adamw(jparams)
    losses_ref = []
    for batch, _ in zip(j_batches(JCFG.vocab_size, SEQ, BATCH, jt.seed),
                        range(3)):
        jp, jopt, m = step(jp, jopt, {k: jnp.asarray(v)
                                      for k, v in batch.items()})
        losses_ref.append(float(m["loss"]))
    fields = {f.name for f in dataclasses.fields(TrainConfig)}
    tcfg = TrainConfig(**{k: v for k, v in dataclasses.asdict(jt).items()
                          if k in fields and k != "checkpoint_dir"})
    params, _, history = train(cfg, tcfg, device="cpu",
                               params=_port_params(tp, jparams, cfg),
                               log=lambda _: None)
    np.testing.assert_allclose([h["loss"] for h in history], losses_ref,
                               rtol=1e-4)
    lr_sum = sum(h["lr"] for h in history)
    for i, (got, want) in enumerate(zip(tree_leaves(params), tree_leaves(
            _port_params(tp, jp, cfg)))):
        err = np.abs(f32(got) - f32(want))
        assert err.max() <= lr_sum, (i, err.max())
        n_far = int((err > 2e-3 * jt.learning_rate).sum())
        assert n_far <= 1e-4 * err.size, (i, n_far, err.size)


SERVE_JCFG = FULL.reduced().replace(num_experts=16, top_k=8, num_heads=8,
                                    num_kv_heads=1)
CAPACITY, MAX_NEW = 48, 5


@pytest.fixture(scope="module")
def serve_params(tp):
    jp = JT.init_params(jax.random.PRNGKey(0), SERVE_JCFG)
    cfg = torch_config(SERVE_JCFG).replace(moe_impl="blaze_pallas")
    return jp, tp.interop.params_from_jax(np_params(jp), cfg, device="cpu")


def test_prefill_and_decode_logits_match(tp, serve_params):
    TT, torch = tp.transformer, tp.torch
    jp, tparams = serve_params
    cfg = torch_config(SERVE_JCFG).replace(moe_impl="blaze_pallas")
    rng = np.random.default_rng(0)
    B, S, ps = 2, 16, 8
    lengths = np.array([5, 11], np.int32)
    tokens = np.zeros((B, S), np.int32)
    for b, n in enumerate(lengths):
        tokens[b, :n] = rng.integers(3, SERVE_JCFG.vocab_size, size=n)
    table = np.array([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)
    jcache = JT.init_paged_cache(SERVE_JCFG, 9, ps)
    tcache = TT.init_paged_cache(cfg, 9, ps, "cpu")
    jl, jcache = JT.prefill(jp, jnp.asarray(tokens), jnp.asarray(lengths),
                            jcache, jnp.asarray(table), SERVE_JCFG)
    with torch.inference_mode():
        tl = TT.prefill(tparams, to_torch(tokens), to_torch(lengths), tcache,
                        to_torch(table), cfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)
    pos = lengths.copy()
    for _ in range(3):
        tok = rng.integers(3, SERVE_JCFG.vocab_size,
                           size=(B, 1)).astype(np.int32)
        jl, jcache = JT.paged_decode_step(jp, jcache, jnp.asarray(tok),
                                          jnp.asarray(pos),
                                          jnp.asarray(table), SERVE_JCFG)
        with torch.inference_mode():
            tl = TT.paged_decode_step(tparams, tcache, to_torch(tok),
                                      to_torch(pos), to_torch(table), cfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-4)
        pos += 1


def test_engine_greedy_tokens_match_reference_model(tp, serve_params):
    """Four prompts on three slots (one refills a slot), greedy, against
    the reference model's own greedy continuation (``forward`` over the
    prompt and the tokens so far, as ``tests/test_torch_serve.py``)."""
    jp, tparams = serve_params
    rng = np.random.default_rng(1)
    prompts = [rng.integers(3, SERVE_JCFG.vocab_size, size=n)
               .astype(np.int32) for n in (3, 30, 17, 9)]
    fwd = jax.jit(lambda p, t: JT.forward(p, {"tokens": t}, SERVE_JCFG)[0])
    seqs = [list(p) for p in prompts]
    for _ in range(MAX_NEW):
        toks = np.zeros((len(seqs), CAPACITY), np.int32)
        for i, q in enumerate(seqs):
            toks[i, :len(q)] = q
        logits = np.asarray(fwd(jp, jnp.asarray(toks)))
        for i, q in enumerate(seqs):
            q.append(int(logits[i, len(q) - 1].argmax()))
    want = [q[len(p):] for q, p in zip(seqs, prompts)]
    cfg = torch_config(SERVE_JCFG).replace(moe_impl="blaze_pallas")
    eng = tp.engine.ServeEngine(cfg, tparams, batch_slots=3,
                                capacity=CAPACITY, page_size=16,
                                device="cpu")
    reqs = [tp.engine.Request(prompt=p, max_new_tokens=MAX_NEW,
                              eos_id=SERVE_JCFG.vocab_size) for p in prompts]
    eng.generate(reqs)
    assert [r.out_tokens for r in reqs] == want
