"""Port parity: the recurrent and hybrid models (Hymba-1.5B, xLSTM-1.3B)
and the three dense configs added with them (Gemma2-27B, Yi-6B,
DeepSeek-Coder-33B).

- Each new config of the port converts from the reference's field for
  field, reduced and at full size.
- ``forward`` logits, ``train_loss`` and its gradients for reduced Hymba
  (``use_pallas=True``: flash attention and the fused SwiGLU Function
  through their plain versions; the reference's Pallas kernels in
  interpret mode) and xLSTM, from weights converted from the reference's
  init, on the reference pipeline's batch; then a 3-step run of the
  port's ``train`` against the reference's ``make_train_step``.
- The dense configs: ``forward`` logits and the engine's greedy tokens
  against the reference model's greedy continuation
  (``torch_parity.greedy_continuation``).
- The checkpoint plans over the new kinds: ``none`` (a region a group),
  ``paper`` and a spec scoped differently in mLSTM and sLSTM (a region a
  sublayer) give ``full``'s loss and gradients (1e-6: the recompute runs
  the same operations).

Tolerances are those of ``tests/test_torch_dense.py`` (the loss 1e-5
relative, gradients 1e-4 relative over 1e-4 of each leaf's scale, logits
1e-4, the trajectory's losses 1e-4 and its parameters within the summed
step sizes, all but a 1e-4 share of each leaf within 2e-3 of the learning
rate).  xLSTM is cut to one mLSTM and one sLSTM layer (a pattern period
of 2): at a random init its mLSTM normalizer amplifies float32 rounding
from layer to layer, so that two valid chunkings of the reference's own
scan (256 and 16) differ by 2.7e-3 in the logits of the 8-layer reduced
model and by 0.87 at 16 layers, beyond any fixed tolerance; one layer of
each kind holds the gradients to 6e-6 of their scale.  The 8-layer
pattern decodes in ``tests/test_torch_decode.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config
from repro.configs.base import TrainConfig as JTrainConfig
from repro.data.pipeline import make_batch_iterator as j_batches
from repro.models import transformer as JT
from repro.train.loop import make_train_step as j_make_train_step
from repro.train.optimizer import init_adamw as j_init_adamw
from torch_parity import (f32, greedy_continuation, np_params, to_torch,
                          torch_config)
from torch_parity import tp  # noqa: F401

NEW_ARCHS = ("hymba_1_5b", "xlstm_1_3b", "gemma2_27b", "yi_6b",
             "deepseek_coder_33b")
HYMBA = get_config("hymba_1_5b").reduced().replace(use_pallas=True)
XLSTM = get_config("xlstm_1_3b").reduced().replace(
    block_pattern=("mlstm", "slstm"), slstm_every=2, num_layers=2)
BATCH, SEQ = 2, 64


def test_new_configs_convert_field_for_field():
    from repro_torch.configs import ARCH_IDS
    from repro_torch.configs import get_config as t_get_config
    aliases = ("hymba-1.5b", "xlstm-1.3b", "gemma2-27b", "yi-6b",
               "deepseek-coder-33b")
    for arch, alias in zip(NEW_ARCHS, aliases):
        ref = get_config(arch)
        port = t_get_config(alias)
        assert arch in ARCH_IDS and t_get_config(arch) == port
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert port.reduced() == torch_config(ref.reduced())


def _port_params(tp, jp, cfg):
    return tp.interop.params_from_jax(np_params(jp), cfg, device="cpu",
                                      dtype=tp.torch.float32)


@pytest.mark.parametrize("jcfg", [HYMBA, XLSTM], ids=["hymba", "xlstm"])
def test_forward_loss_and_grads_match_reference(tp, jcfg):
    from repro_torch.train.optimizer import tree_leaves
    tcfg = torch_config(jcfg)
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    batch = next(j_batches(jcfg.vocab_size, SEQ, BATCH, seed=0))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    logits_ref = jax.jit(lambda p: JT.forward(
        p, {"tokens": jbatch["tokens"]}, jcfg)[0])(jp)
    (loss_ref, met_ref), grads_ref = jax.jit(jax.value_and_grad(
        lambda p: JT.train_loss(p, jbatch, jcfg), has_aux=True))(jp)
    params = _port_params(tp, jp, tcfg)
    assert set(params["layers"][0]) == (
        {"ln1", "ln2", "attn", "mamba", "ffn"} if "hymba" in jcfg.block_pattern
        else {"ln1", "mlstm"})
    if "hymba" in jcfg.block_pattern:
        assert params["layers"][0]["mamba"]["a_log"].dtype == tp.torch.float32
    with tp.torch.no_grad():
        logits, aux = tp.transformer.forward(
            params, {"tokens": to_torch(batch["tokens"])}, tcfg)
    np.testing.assert_allclose(f32(logits), f32(logits_ref), rtol=1e-4,
                               atol=1e-4)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, met = tp.transformer.train_loss(
        params, {k: to_torch(v) for k, v in batch.items()}, tcfg)
    grads = tp.torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(loss_ref),
                               rtol=1e-5)
    assert float(aux) == 0.0 == float(met_ref["aux"]) == float(met["aux"])
    want_tree = tree_leaves(_port_params(tp, grads_ref, tcfg))
    assert len(want_tree) == len(grads)
    for i, (got, want) in enumerate(zip(grads, want_tree)):
        want = f32(want)
        np.testing.assert_allclose(f32(got), want, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(want).max()),
                                   err_msg=f"leaf {i}")


@pytest.mark.parametrize("jcfg", [HYMBA, XLSTM], ids=["hymba", "xlstm"])
def test_three_step_trajectory_matches_reference(tp, jcfg):
    from repro_torch.configs import TrainConfig
    from repro_torch.train.loop import train
    from repro_torch.train.optimizer import tree_leaves
    tcfg_m = torch_config(jcfg)
    jt = JTrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=3,
                      batch_size=BATCH, seq_len=SEQ, log_every=1)
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg)
    step = jax.jit(j_make_train_step(jcfg, jt))
    jp, jopt = jparams, j_init_adamw(jparams)
    losses_ref = []
    for batch in [b for b, _ in zip(j_batches(jcfg.vocab_size, SEQ, BATCH,
                                              jt.seed), range(3))]:
        jp, jopt, m = step(jp, jopt, {k: jnp.asarray(v)
                                      for k, v in batch.items()})
        losses_ref.append(float(m["loss"]))
    fields = {f.name for f in dataclasses.fields(TrainConfig)}
    tcfg = TrainConfig(**{k: v for k, v in dataclasses.asdict(jt).items()
                          if k in fields})
    params, _, history = train(tcfg_m, tcfg, device="cpu",
                               params=_port_params(tp, jparams, tcfg_m),
                               log=lambda _: None)
    np.testing.assert_allclose([h["loss"] for h in history], losses_ref,
                               rtol=1e-4)
    lr_sum = sum(h["lr"] for h in history)
    for i, (got, want) in enumerate(zip(tree_leaves(params),
                                        tree_leaves(_port_params(tp, jp,
                                                                 tcfg_m)))):
        err = np.abs(f32(got) - f32(want))
        assert err.max() <= lr_sum, (i, err.max())
        n_far = int((err > 2e-3 * jt.learning_rate).sum())
        assert n_far <= 1e-4 * err.size, (i, n_far, err.size)


@pytest.mark.parametrize("arch", ["gemma2_27b", "yi_6b",
                                  "deepseek_coder_33b"])
def test_dense_configs_forward_and_engine_tokens(tp, arch):
    """The port's own reduced config (bf16 weights would round; float32,
    as the reference's reduced configs): ``forward`` logits, then the
    engine's greedy tokens on 3 slots against the reference model's
    greedy continuation."""
    from repro_torch.configs import get_config as t_get_config
    jcfg = get_config(arch).reduced()
    tcfg = t_get_config(arch).reduced().replace(use_pallas=True)
    jp = JT.init_params(jax.random.PRNGKey(1), jcfg)
    params = tp.interop.params_from_jax(np_params(jp), tcfg, device="cpu")
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, jcfg.vocab_size, size=(2, 128)).astype(np.int32)
    logits_ref, _ = jax.jit(lambda p, t: JT.forward(p, {"tokens": t},
                                                    jcfg))(
        jp, jnp.asarray(tokens))
    with tp.torch.no_grad():
        logits, _ = tp.transformer.forward(
            params, {"tokens": to_torch(tokens)}, tcfg)
    np.testing.assert_allclose(f32(logits), f32(logits_ref), rtol=1e-4,
                               atol=1e-4)
    # one prompt past the reduced local window (64)
    prompts = [rng.integers(3, jcfg.vocab_size, size=n).astype(np.int32)
               for n in (5, 70, 17, 30)]
    want = greedy_continuation(jp, jcfg, prompts, 5, 128)
    eng = tp.engine.ServeEngine(tcfg, params, batch_slots=3, capacity=128,
                                page_size=16, device="cpu")
    reqs = eng.generate([tp.engine.Request(prompt=p, max_new_tokens=5,
                                           eos_id=jcfg.vocab_size)
                         for p in prompts])
    assert [r.out_tokens for r in reqs] == want


@pytest.mark.parametrize("arch,spec", [
    ("hymba_1_5b", "paper"),
    # scoped differently in the two kinds of the pattern: one checkpoint
    # region a sublayer (plan_policies' per-kind mode)
    ("xlstm_1_3b", "none;slstm:save=ssm_state")])
def test_checkpoint_plans_keep_the_gradients(tp, arch, spec):
    """The recurrent and hybrid kinds under the checkpoint plans: the
    default ``none`` (one region a group, everything recomputed), ``spec``
    and ``full`` (no region) give the same loss and gradients."""
    from repro_torch.core import checkpoint as CK
    from repro_torch.train.optimizer import tree_leaves
    torch = tp.torch
    cfg = torch_config(HYMBA if arch == "hymba_1_5b" else XLSTM)
    if arch == "xlstm_1_3b":
        assert CK.plan_policies(CK.get_plan(spec), cfg.block_pattern)[0] \
            == "per_kind"
    params = tp.interop.init_params(cfg, torch.Generator().manual_seed(0),
                                    "cpu", dtype=torch.float32)
    batch = next(j_batches(cfg.vocab_size, 32, 2, seed=1))
    batch = {k: to_torch(v) for k, v in batch.items()}
    out = {}
    for plan in ("full", "none", spec):
        leaves = [t.detach().requires_grad_() for t in tree_leaves(params)]
        it = iter(leaves)

        def swap(tree):
            if isinstance(tree, dict):
                return {k: swap(v) for k, v in tree.items()}
            if isinstance(tree, list):
                return [swap(v) for v in tree]
            return next(it)

        loss, _ = tp.transformer.train_loss(
            swap(params), batch, cfg.replace(remat_policy=plan))
        out[plan] = [loss.detach()] + list(
            torch.autograd.grad(loss, leaves))
    for plan in ("none", spec):
        for i, (a, b) in enumerate(zip(out[plan], out["full"])):
            np.testing.assert_allclose(f32(a), f32(b), rtol=1e-6,
                                       atol=1e-6 * float(np.abs(f32(b))
                                                         .max()),
                                       err_msg=f"{plan} leaf {i}")
