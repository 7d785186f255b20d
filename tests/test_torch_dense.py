"""Port parity: the dense SwiGLU model (Qwen3-14B) in training.

- The port's Qwen3-14B config converts from the reference's field for field.
- ``train_loss`` and its gradients on the reduced Qwen3-14B in float32 with
  ``use_pallas=True`` (the port's fused-SwiGLU Function and flash
  attention, here through their plain versions; the reference's Pallas
  kernels in interpret mode), from the same weights and pipeline batch;
  also with a GQA group of 5 (``num_heads=5, num_kv_heads=1``).
- A 3-step float32 run of the port's ``train`` against the reference's
  ``make_train_step`` on the same pipeline batches.
- ``forward`` of a reduced Gemma2-27B (``attn_local_ffn`` / ``attn_ffn``
  alternating, ``post_norms``, attention and final softcaps) against the
  reference's, with ``use_pallas`` off and on in the port.

Tolerances: those of ``tests/test_torch_train.py`` — the loss 1e-5
relative, its gradients 1e-4 relative over a floor of 1e-4 times each
leaf's scale; the trajectory's losses 1e-4, every parameter within the sum
of the step sizes and all but a 1e-4 share of each leaf's elements within
2e-3 of the learning rate; logits 1e-4 (two to four layers of float32
sums in another order).
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
from torch_parity import f32, np_params, to_torch, torch_config
from torch_parity import tp  # noqa: F401

JCFG = get_config("qwen3_14b").reduced().replace(use_pallas=True)
JCFG_G5 = JCFG.replace(num_heads=5, num_kv_heads=1)
TCFG = torch_config(JCFG)
BATCH, SEQ = 2, 128


def test_qwen3_14b_config_converts_field_for_field():
    from repro_torch.configs import get_config as t_get_config
    ref = get_config("qwen3_14b")
    port = t_get_config("qwen3-14b")
    assert port == torch_config(ref)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.reduced() == torch_config(ref.reduced())


def _port_params(tp, jp, cfg):
    return tp.interop.params_from_jax(np_params(jp), cfg, device="cpu",
                                      dtype=tp.torch.float32)


@pytest.mark.parametrize("jcfg", [JCFG, JCFG_G5], ids=["gqa2", "gqa5"])
def test_dense_train_loss_and_grads_match_reference(tp, jcfg):
    from repro_torch.train.optimizer import tree_leaves
    tcfg = torch_config(jcfg)
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    batch = next(j_batches(jcfg.vocab_size, SEQ, BATCH, seed=0))
    (loss_ref, met_ref), grads_ref = jax.value_and_grad(
        lambda p: JT.train_loss(p, {k: jnp.asarray(v)
                                    for k, v in batch.items()}, jcfg),
        has_aux=True)(jp)
    params = _port_params(tp, jp, tcfg)
    assert params["layers"][0]["attn"]["q_norm"].dtype == tp.torch.float32
    assert set(params["layers"][0]) == {"ln1", "ln2", "attn", "ffn"}
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    tbatch = {k: to_torch(v) for k, v in batch.items()}
    loss, met = tp.transformer.train_loss(params, tbatch, tcfg)
    grads = tp.torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(loss_ref),
                               rtol=1e-5)
    assert float(met["aux"]) == 0.0 == float(met_ref["aux"])
    want_tree = tree_leaves(_port_params(tp, grads_ref, tcfg))
    assert len(want_tree) == len(grads)
    for i, (got, want) in enumerate(zip(grads, want_tree)):
        want = f32(want)
        np.testing.assert_allclose(f32(got), want, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(want).max()),
                                   err_msg=f"leaf {i}")


def test_dense_three_step_trajectory_matches_reference(tp):
    from repro_torch.configs import TrainConfig
    from repro_torch.train.loop import train
    from repro_torch.train.optimizer import tree_leaves
    jt = JTrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=3,
                      batch_size=BATCH, seq_len=SEQ, log_every=1)
    jparams = JT.init_params(jax.random.PRNGKey(0), JCFG)
    step = jax.jit(j_make_train_step(JCFG, jt))
    jp, jopt = jparams, j_init_adamw(jparams)
    losses_ref = []
    for batch in [b for b, _ in zip(j_batches(JCFG.vocab_size, SEQ, BATCH,
                                              jt.seed), range(3))]:
        jp, jopt, m = step(jp, jopt, {k: jnp.asarray(v)
                                      for k, v in batch.items()})
        losses_ref.append(float(m["loss"]))
    fields = {f.name for f in dataclasses.fields(TrainConfig)}
    tcfg = TrainConfig(**{k: v for k, v in dataclasses.asdict(jt).items()
                          if k in fields})
    params, _, history = train(TCFG, tcfg, device="cpu",
                               params=_port_params(tp, jparams, TCFG),
                               log=lambda _: None)
    np.testing.assert_allclose([h["loss"] for h in history], losses_ref,
                               rtol=1e-4)
    lr_sum = sum(h["lr"] for h in history)
    for i, (got, want) in enumerate(zip(tree_leaves(params),
                                        tree_leaves(_port_params(tp, jp,
                                                                 TCFG)))):
        err = np.abs(f32(got) - f32(want))
        assert err.max() <= lr_sum, (i, err.max())
        n_far = int((err > 2e-3 * jt.learning_rate).sum())
        assert n_far <= 1e-4 * err.size, (i, n_far, err.size)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_gemma2_forward_matches_reference(tp, use_pallas):
    """Local/global alternation, sandwich norms and both softcaps; the
    reduced window (64) is shorter than the sequence (128)."""
    jcfg = get_config("gemma2_27b").reduced()
    assert jcfg.block_pattern == ("attn_local_ffn", "attn_ffn")
    assert jcfg.post_norms and jcfg.attn_softcap and jcfg.final_softcap
    tcfg = torch_config(jcfg).replace(use_pallas=use_pallas)
    jp = JT.init_params(jax.random.PRNGKey(2), jcfg)
    tokens = np.random.default_rng(4).integers(
        0, jcfg.vocab_size, size=(BATCH, SEQ)).astype(np.int32)
    logits_ref, aux_ref = JT.forward(jp, {"tokens": jnp.asarray(tokens)},
                                     jcfg)
    params = _port_params(tp, jp, tcfg)
    assert "ln2_post" in params["layers"][0]
    with tp.torch.no_grad():
        logits, aux = tp.transformer.forward(
            params, {"tokens": to_torch(tokens)}, tcfg)
    np.testing.assert_allclose(f32(logits), f32(logits_ref), rtol=1e-4,
                               atol=1e-4)
    assert float(aux) == 0.0 == float(aux_ref)
