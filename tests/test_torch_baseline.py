"""Port parity: the paper's comparison baselines (``core/baseline.py``) and
``moe_impl="megablocks"`` / ``"dense"``.

- ``moe_ffn_megablocks`` (the materialized routed buffer, plain autograd):
  the output and the gradients of x, the gates and the expert weights
  against ``jax.vjp`` of the reference's on the same inputs, with the port
  on ``segment``, ``ragged`` and ``pallas`` (the plain versions on the
  CPU), in float32 and bfloat16.  The reference runs its ``segment``
  backend, the oracle its own tests hold every backend to (its ``pallas``
  one does not trace on the installed JAX).
- ``moe_ffn_dense`` (the masked dense oracle) likewise, and the port's
  megablocks layer against its dense oracle.
- The MoE sublayer with each baseline from weights converted by
  ``interop.params_from_jax`` against the reference's ``_moe_local``, and
  ``train_loss`` with its gradients under ``moe_impl="megablocks"``.

Tolerances: float32 1e-4 relative over 1e-5 absolute, the reference's for
megablocks across backends (``tests/test_gmm_backend.py:160-200``);
bfloat16 5e-2 relative and absolute (``tests/test_fused_path.py``, as
``test_torch_moe_layer.py`` uses); the sublayer 1e-5 and the loss's
gradients 1e-4 of each leaf's scale, as ``test_torch_moe_layer.py`` and
``test_torch_train.py`` hold ``blaze``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.bench.memory import bench_config
from repro.configs import get_config
from repro.core import routing as R
from repro.core.baseline import moe_ffn_dense as j_dense
from repro.core.baseline import moe_ffn_megablocks as j_megablocks
from repro.models import moe_block as JMB
from repro.models import transformer as JT
from torch_parity import as_dtype, f32, np_params, to_torch, torch_config
from torch_parity import tp  # noqa: F401

L, D, H, E, K = 48, 32, 48, 4, 2


def _tol(dtype):
    return (dict(rtol=5e-2, atol=5e-2) if dtype == "bfloat16"
            else dict(rtol=1e-4, atol=1e-5))


def _inputs(dtype, seed=7):
    """x, gates, w1, w2, w3 (SwiGLU), top-k with expert 2 left empty, the
    router probabilities and dy."""
    rng = np.random.default_rng(seed)
    x = as_dtype(rng.normal(size=(L, D)), dtype)
    w1, w2 = (as_dtype(rng.normal(size=(E, D, H)) * 0.1, dtype)
              for _ in range(2))
    w3 = as_dtype(rng.normal(size=(E, H, D)) * 0.1, dtype)
    scores = rng.normal(size=(L, E)).astype(np.float32)
    scores[:, 2] -= 100.0
    probs = np.exp(scores) / np.exp(scores).sum(1, keepdims=True)
    topk = np.argsort(-scores, axis=1)[:, :K].astype(np.int32)
    g = np.take_along_axis(probs, topk, 1)
    gates = as_dtype(g / g.sum(1, keepdims=True), dtype)
    dy = as_dtype(rng.normal(size=(L, D)), dtype)
    return x, gates, w1, w2, w3, topk, probs, dy


def _grads_ref(fn, ins, dy):
    def f(ins, dy):
        y, vjp = jax.vjp(fn, *ins)
        return y, vjp(dy)
    return jax.jit(f)(tuple(jnp.asarray(a) for a in ins), jnp.asarray(dy))


def _check(tp, fn, ins, y_ref, grads_ref, dy, dtype, names):
    ts = [to_torch(a).requires_grad_() for a in ins]
    y = fn(*ts)
    assert y.dtype == ts[0].dtype
    y.backward(to_torch(dy))
    np.testing.assert_allclose(f32(y), f32(y_ref), **_tol(dtype))
    for name, t, r in zip(names, ts, grads_ref):
        assert t.grad.dtype == t.dtype, name
        np.testing.assert_allclose(f32(t.grad), f32(r), **_tol(dtype),
                                   err_msg=f"d{name}")
    return ts


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("backend", ["segment", "ragged", "pallas"])
def test_megablocks_matches_reference(tp, backend, dtype):
    from repro_torch.core.baseline import moe_ffn_megablocks
    x, gates, w1, w2, w3, topk, _, dy = _inputs(dtype)
    jd = R.build_dispatch(jnp.asarray(topk), E)
    y_ref, grads_ref = _grads_ref(
        lambda x_, g_, w1_, w2_, w3_: j_megablocks(
            x_, g_, jd, w1_, w3_, w2_, backend="segment"),
        (x, gates, w1, w2, w3), dy)
    td = tp.routing.build_dispatch(to_torch(topk), E)
    ts = _check(tp, lambda x_, g_, w1_, w2_, w3_: moe_ffn_megablocks(
        x_, g_, td, w1_, w3_, w2_, backend=backend),
        (x, gates, w1, w2, w3), y_ref, grads_ref, dy, dtype,
        ("x", "gates", "w1", "w2", "w3"))
    assert not ts[2].grad[2].any(), "the empty expert's dw1 must be zero"


@pytest.mark.parametrize("activation", ["silu", "gelu"])
def test_megablocks_mlp_matches_reference(tp, activation):
    from repro_torch.core.baseline import moe_ffn_megablocks
    x, gates, w1, _, w3, topk, _, dy = _inputs("float32", seed=8)
    jd = R.build_dispatch(jnp.asarray(topk), E)
    y_ref, grads_ref = _grads_ref(
        lambda x_, g_, w1_, w3_: j_megablocks(
            x_, g_, jd, w1_, w3_, activation=activation, backend="segment"),
        (x, gates, w1, w3), dy)
    td = tp.routing.build_dispatch(to_torch(topk), E)
    _check(tp, lambda x_, g_, w1_, w3_: moe_ffn_megablocks(
        x_, g_, td, w1_, w3_, activation=activation, backend="segment"),
        (x, gates, w1, w3), y_ref, grads_ref, dy, "float32",
        ("x", "gates", "w1", "w3"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_oracle_matches_reference(tp, dtype):
    from repro_torch.core.baseline import moe_ffn_dense
    x, gates, w1, w2, w3, topk, probs, dy = _inputs(dtype, seed=9)
    y_ref, grads_ref = _grads_ref(
        lambda x_, g_, w1_, w2_, w3_: j_dense(
            x_, jnp.asarray(probs), jnp.asarray(topk), g_, w1_, w3_, w2_),
        (x, gates, w1, w2, w3), dy)
    tprobs, ttopk = to_torch(probs), to_torch(topk)
    _check(tp, lambda x_, g_, w1_, w2_, w3_: moe_ffn_dense(
        x_, tprobs, ttopk, g_, w1_, w3_, w2_),
        (x, gates, w1, w2, w3), y_ref, grads_ref, dy, dtype,
        ("x", "gates", "w1", "w2", "w3"))


def test_megablocks_matches_dense_oracle(tp):
    """The port's two baselines against each other, float32, at the
    reference's own tolerance for this comparison
    (``tests/test_gmm_backend.py:test_segment_matches_moe_dense_oracle``)."""
    from repro_torch.core.baseline import moe_ffn_dense, moe_ffn_megablocks
    x, gates, w1, w2, w3, topk, probs, _ = (to_torch(a)
                                            for a in _inputs("float32"))
    td = tp.routing.build_dispatch(topk, E)
    y = moe_ffn_megablocks(x, gates, td, w1, w3, w2, backend="pallas")
    yd = moe_ffn_dense(x, probs, topk, gates, w1, w3, w2)
    np.testing.assert_allclose(f32(y), f32(yd), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("impl,backend", [("megablocks", "segment"),
                                          ("megablocks", "pallas"),
                                          ("dense", "segment")])
def test_baseline_sublayer_from_converted_weights(tp, impl, backend):
    """The MoE sublayer of the reduced Mixtral with ``moe_impl`` a
    baseline, weights from the reference's init converted by
    ``params_from_jax``: output and auxiliary loss against the reference's
    ``_moe_local`` (its ``segment`` backend)."""
    from repro_torch.models.moe_block import moe_local
    jcfg = get_config("mixtral_8x7b").reduced().replace(
        moe_impl=impl, gmm_backend="segment")
    tcfg = torch_config(jcfg).replace(gmm_backend=backend)
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    jmoe = jax.tree.map(lambda a: a[0], jp["layers"][0]["moe"])
    xf = np.random.default_rng(3).normal(
        size=(48, jcfg.d_model)).astype(np.float32)
    y_ref, aux_ref = jax.jit(lambda x_, p_: JMB._moe_local(x_, p_, jcfg))(
        jnp.asarray(xf), jmoe)
    tparams = tp.interop.params_from_jax(np_params(jp), tcfg, device="cpu",
                                         dtype=tp.torch.float32)
    y, aux = moe_local(to_torch(xf), tparams["layers"][0]["moe"], tcfg)
    np.testing.assert_allclose(f32(y), f32(y_ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(aux), float(aux_ref), rtol=1e-5)


def test_megablocks_train_loss_and_grads_match_reference(tp):
    """``train_loss`` and its gradients on the small MoE config of the
    reference's memory bench with ``moe_impl="megablocks"`` (batch 2 x 32),
    against ``jax.value_and_grad`` of the reference's."""
    from repro_torch.train.optimizer import tree_leaves
    jcfg = bench_config().replace(moe_impl="megablocks",
                                  gmm_backend="segment")
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    toks = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, size=(2, 32)).astype(np.int32)
    batch = {"tokens": toks, "labels": toks}
    (loss_ref, _), grads_ref = jax.jit(jax.value_and_grad(
        lambda p: JT.train_loss(p, {k: jnp.asarray(v)
                                    for k, v in batch.items()}, jcfg),
        has_aux=True))(jp)
    tcfg = torch_config(jcfg)
    params = tp.interop.params_from_jax(np_params(jp), tcfg, device="cpu",
                                        dtype=tp.torch.float32)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, _ = tp.transformer.train_loss(
        params, {k: to_torch(v) for k, v in batch.items()}, tcfg)
    grads = tp.torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(loss_ref),
                               rtol=1e-5)
    want = tree_leaves(tp.interop.params_from_jax(
        np_params(grads_ref), tcfg, device="cpu", dtype=tp.torch.float32))
    for i, (got, w) in enumerate(zip(grads, want)):
        w = f32(w)
        np.testing.assert_allclose(f32(got), w, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(w).max()),
                                   err_msg=f"leaf {i}")
