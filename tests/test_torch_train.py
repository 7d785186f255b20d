"""Port parity: the training slice.

- The kernel-composed expert layer's autograd Function (y and the
  gradients of x, the gates and the three expert weights) against
  ``jax.vjp`` of the reference's ``moe_ffn_blaze`` with the same Algorithm-1
  backward (``residuals="ab_yswi"``, segment backend).  The reference's
  Pallas gather-GMM does not trace on the installed JAX, so its
  ``moe_ffn_blaze_pallas`` cannot be differentiated here.
- The bf16 deviation: the reference multiplies bf16 activations by float32
  expert weights; the port rounds the weights to bf16 first.
- ``train_loss`` and its gradients on the reduced Mixtral in float32
  against ``jax.value_and_grad`` of the reference's ``train_loss`` (its
  ``moe_impl="blaze"`` on the segment backend, ``use_pallas=True``), from
  the same weights and pipeline batch.
- A 3-step float32 run of the port's ``train`` against the reference's
  ``make_train_step`` on the same pipeline batches.
- The last two again with the port on the reference's default expert layer
  (``moe_impl="blaze"``) and the ``pallas_fused`` backend: the fused kernel
  pair's plain versions.

Tolerances (float32): the layer 1e-5 relative over a floor of 1e-5 times
each output's scale (the same sums in another order); the reduced model's
loss 1e-5 and its gradients 1e-4 relative over a floor of 1e-4 times each
leaf's scale (two layers, routing on float32 logits, attention through the
Pallas kernel in interpret mode on one side).  The trajectory's losses to
1e-4.  Its parameters: AdamW divides each gradient element by its own
magnitude, so an element whose gradient sits at the float32 noise of the
two sides may step by up to the learning rate in either direction.  So
every element is held to the sum of the step sizes, and all but a 1e-4
share of each leaf's elements to 2e-3 times the learning rate.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config
from repro.configs.base import TrainConfig as JTrainConfig
from repro.core import routing as R
from repro.core.moe_layer import moe_ffn_blaze
from repro.data.pipeline import make_batch_iterator as j_batches
from repro.models import transformer as JT
from repro.train.loop import make_train_step as j_make_train_step
from repro.train.optimizer import init_adamw as j_init_adamw
from torch_parity import as_dtype, f32, np_params, to_torch, torch_config
from torch_parity import tp  # noqa: F401

L, D, H, E, K = 48, 32, 64, 4, 2
JCFG = get_config("mixtral_8x7b").reduced().replace(
    moe_impl="blaze", gmm_backend="segment", use_pallas=True)
TCFG = torch_config(JCFG).replace(moe_impl="blaze_pallas")
TCFG_FUSED = torch_config(JCFG).replace(gmm_backend="pallas_fused")
BATCH, SEQ = 2, 128          # SEQ > the reduced sliding window of 64


def _layer_inputs(dtype, seed=3):
    """x, float32 expert weights, top-k with expert 1 left empty, gates."""
    rng = np.random.default_rng(seed)
    x = as_dtype(rng.normal(size=(L, D)), dtype)
    w1, w2 = (rng.normal(size=(E, D, H)).astype(np.float32) * 0.2
              for _ in range(2))
    w3 = rng.normal(size=(E, H, D)).astype(np.float32) * 0.2
    scores = rng.normal(size=(L, E)).astype(np.float32)
    scores[:, 1] -= 100.0
    topk = np.argsort(-scores, axis=1)[:, :K].astype(np.int32)
    g = np.exp(np.take_along_axis(scores, topk, 1))
    g = g / g.sum(1, keepdims=True)
    dy = rng.normal(size=(L, D)).astype(np.float32)
    return x, w1, w2, w3, topk, as_dtype(g, dtype), dy


def test_moe_layer_grads_match_reference(tp):
    x, w1, w2, w3, topk, g, dy = _layer_inputs("float32")
    jd = R.build_dispatch(jnp.asarray(topk), E)
    y_ref, vjp = jax.vjp(
        lambda x_, g_, w1_, w2_, w3_: moe_ffn_blaze(
            x_, g_, jd, w1_, w3_, w2_, residuals="ab_yswi",
            backend="segment"),
        *(jnp.asarray(a) for a in (x, g, w1, w2, w3)))
    grads_ref = vjp(jnp.asarray(dy))
    td = tp.routing.build_dispatch(to_torch(topk), E)
    tx, tg, t1, t2, t3 = (to_torch(a).requires_grad_()
                          for a in (x, g, w1, w2, w3))
    y = tp.ops.moe_ffn_blaze_pallas(tx, tg, td, t1, t3, t2)
    y.backward(to_torch(dy))
    want = f32(y_ref)
    np.testing.assert_allclose(f32(y), want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))
    for name, t, r in zip(("x", "gates", "w1", "w2", "w3"),
                          (tx, tg, t1, t2, t3), grads_ref):
        want = f32(r)
        np.testing.assert_allclose(f32(t.grad), want, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(want).max()),
                                   err_msg=f"d{name}")
    assert not t1.grad[1].any(), "the empty expert's dw1 must be zero"


def test_moe_layer_bf16_weight_rounding_is_bounded(tp):
    """The reference with float32 expert weights and bf16 x against the
    port with the weights rounded to bf16.  Each weight moves by at most
    2^-9 relative; through both products the outputs stay within two bf16
    steps (2^-7 relative each) of the output's largest magnitude."""
    x, w1, w2, w3, topk, g, _ = _layer_inputs("bfloat16", seed=4)
    jd = R.build_dispatch(jnp.asarray(topk), E)
    y_ref = moe_ffn_blaze(jnp.asarray(x), jnp.asarray(g), jd,
                          jnp.asarray(w1), jnp.asarray(w3), jnp.asarray(w2),
                          residuals="ab_yswi", backend="segment")
    bf16 = tp.torch.bfloat16
    td = tp.routing.build_dispatch(to_torch(topk), E)
    y = tp.ops.moe_ffn_blaze_pallas(
        to_torch(x), to_torch(g), td, to_torch(w1).to(bf16),
        to_torch(w3).to(bf16), to_torch(w2).to(bf16))
    assert y.dtype == bf16
    want = f32(y_ref)
    np.testing.assert_allclose(f32(y), want, rtol=0.0,
                               atol=2 * 2 ** -7 * float(np.abs(want).max()))


@pytest.fixture(scope="module")
def jparams():
    return JT.init_params(jax.random.PRNGKey(0), JCFG)


def _port_params(tp, jp):
    return tp.interop.params_from_jax(np_params(jp), TCFG, device="cpu",
                                      dtype=tp.torch.float32)


def test_train_loss_and_grads_match_reference(tp, jparams):
    _check_train_loss(tp, jparams, TCFG)


def test_train_loss_and_grads_match_reference_blaze_fused(tp, jparams):
    _check_train_loss(tp, jparams, TCFG_FUSED)


def _check_train_loss(tp, jparams, tcfg):
    from repro_torch.train.optimizer import tree_leaves
    batch = next(j_batches(JCFG.vocab_size, SEQ, BATCH, seed=0))
    (loss_ref, met_ref), grads_ref = jax.value_and_grad(
        lambda p: JT.train_loss(p, {k: jnp.asarray(v)
                                    for k, v in batch.items()}, JCFG),
        has_aux=True)(jparams)
    params = _port_params(tp, jparams)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    tbatch = {k: to_torch(v) for k, v in batch.items()}
    loss, met = tp.transformer.train_loss(params, tbatch, tcfg)
    grads = tp.torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(loss_ref),
                               rtol=1e-5)
    np.testing.assert_allclose(float(met["ce"].detach()),
                               float(met_ref["ce"]), rtol=1e-5)
    np.testing.assert_allclose(float(met["aux"].detach()),
                               float(met_ref["aux"]), rtol=1e-4)
    want_tree = tree_leaves(_port_params(tp, grads_ref))
    assert len(want_tree) == len(grads)
    for i, (got, want) in enumerate(zip(grads, want_tree)):
        want = f32(want)
        np.testing.assert_allclose(f32(got), want, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(want).max()),
                                   err_msg=f"leaf {i}")


def test_three_step_trajectory_matches_reference(tp, jparams):
    _check_trajectory(tp, jparams, TCFG)


def test_three_step_trajectory_matches_reference_blaze_fused(tp, jparams):
    _check_trajectory(tp, jparams, TCFG_FUSED)


def _check_trajectory(tp, jparams, port_cfg):
    from repro_torch.configs import TrainConfig
    from repro_torch.train.loop import train
    from repro_torch.train.optimizer import tree_leaves
    jt = JTrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=3,
                      batch_size=BATCH, seq_len=SEQ, log_every=1)
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
    params, _, history = train(port_cfg, tcfg, device="cpu",
                               params=_port_params(tp, jparams),
                               log=lambda _: None)
    np.testing.assert_allclose([h["loss"] for h in history], losses_ref,
                               rtol=1e-4)
    assert [h["lr"] for h in history] == pytest.approx([0.0, 1e-3, 5.5e-4])
    lr_sum = sum(h["lr"] for h in history)
    for i, (got, want) in enumerate(zip(tree_leaves(params),
                                        tree_leaves(_port_params(tp, jp)))):
        err = np.abs(f32(got) - f32(want))
        assert err.max() <= lr_sum, (i, err.max())
        n_far = int((err > 2e-3 * jt.learning_rate).sum())
        assert n_far <= 1e-4 * err.size, (i, n_far, err.size)


def _adamw_case(dtype, n=120_000, seed=7):
    """Parameters, gradients and moments of one leaf after some steps,
    drawn with numpy: (p, g, m, v) with p in ``dtype``."""
    rng = np.random.default_rng(seed)
    p = as_dtype(rng.normal(size=(n,)) * 0.05, dtype)
    g = as_dtype(rng.normal(size=(n,)) * 1e-3, dtype)
    m = (rng.normal(size=(n,)) * 1e-3).astype(np.float32)
    v = (rng.random(size=(n,)) * 1e-3 + 5e-4).astype(np.float32) ** 2
    return p, g, m, v


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_adamw_update_matches_reference(tp, dtype):
    """One AdamW update of a leaf of 1.2e5 elements against the
    reference's ``adamw_update`` (step 5, lr 1e-3, weight decay 0.1).  The
    reference rounds ``p.f32 - lr * delta`` to the leaf's dtype once; a
    bf16 leaf may differ only where the two float32 sums round to a
    neighbouring bf16 value (at most 0.01% of elements, one bf16 step
    each).  A float32 leaf agrees to 1e-6 relative over 1e-7 of the
    leaf's scale (updates that cancel the parameter come near zero).  The moments agree
    to 1e-6 relative over 1e-6 of their scale (each is a sum of two terms
    that may cancel)."""
    from repro.train.optimizer import AdamWState as JAdamWState
    from repro.train.optimizer import adamw_update as j_adamw_update
    from repro_torch.train.optimizer import AdamWState, adamw_update
    torch = tp.torch
    p, g, m, v = _adamw_case(dtype)
    jp, jstate = j_adamw_update(
        jnp.asarray(g), JAdamWState(step=jnp.asarray(4, jnp.int32),
                                    mu=jnp.asarray(m), nu=jnp.asarray(v)),
        jnp.asarray(p), lr=1e-3)
    tparam = to_torch(p)
    state = AdamWState(step=4, mu=[to_torch(m)], nu=[to_torch(v)])
    adamw_update([to_torch(g)], state, [tparam], lr=1e-3)
    assert tparam.dtype == to_torch(p).dtype and state.step == 5
    for got, want in ((state.mu[0], jstate.mu), (state.nu[0], jstate.nu)):
        want = f32(want)
        np.testing.assert_allclose(f32(got), want, rtol=1e-6,
                                   atol=1e-6 * float(np.abs(want).max()))
    got, want = f32(tparam), f32(jp)
    if dtype == "bfloat16":
        step = 2.0 ** (np.floor(np.log2(np.abs(want))) - 7)
        diff = np.abs(got - want)
        assert (diff <= step).all(), float((diff / step).max())
        n_off = int((diff > 0).sum())
        assert n_off <= 1e-4 * diff.size, (n_off, diff.size)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6,
                                   atol=1e-7 * float(np.abs(want).max()))
    assert torch.isfinite(tparam.float()).all()
